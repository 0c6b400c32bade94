"""Multihost elastic supervisor: real processes, real host loss (the
JAX package's ``resilience/multihost.py``).

``resilience.elastic`` respawns a data-parallel world of ranks when a
chaos rule reports a membership change. This module is the same contract
where "host" means an OS process outside any process group:
``run_elastic_multihost`` launches one subprocess a host rank (the port's
``cli train`` with the ``JG_MH_*`` environment, each a single-process
trainer on its own device, exchanging gradients over the
``parallel.hostcomm`` TCP collective), watches their exits, and turns a
SIGKILLed rank into a relaunch at the surviving host count instead of a
dead job:

  1. detect: a killed rank exits with a signal status; its survivors
     notice the dead socket within one step, vacate through the preempt
     path without saving (the step that consumed the zeroed exchange is
     garbage) and exit ``PREEMPT_EXIT_CODE`` (75);
  2. membership, not failure: a signal-killed rank in a generation is a
     host loss: the world shrinks to the survivors, the retry budget is
     not consumed, and the transition is recorded in ``membership.json``
     beside the checkpoint generations on the shared store;
  3. relaunch: a fresh generation of rank processes at the new host
     count (ranks 0..n-1, a fresh conductor port, resume from the newest
     digest-verified generation); the trainer's elastic restore re-folds
     the per-host compression rows (``parallel.remesh``), so the run
     after a shrink is bitwise a fresh resume at that world.

Regrow rides the same loop: the chaos ``host_restore`` rule makes every
rank stop gracefully (checkpoint saved) after rank 0 drops
``restore_request.json`` in the store; the supervisor consumes it and
relaunches at the requested (default: the launch) host count.

Each generation's exits are classified in this order:

  =====================  ==================================================
  every rank 0           training complete -> return
  any rank signal-killed host loss -> shrink to survivors (budget-free)
  restore_request.json   regrow to the requested hosts (budget-free)
  any rank exited 75     plain preemption -> resume, preemption budget
  anything else          transient failure -> backoff, restart budget
  =====================  ==================================================

``host_membership`` events, ``host_remesh_total{direction}`` and the
``host_world_size`` gauge record the transitions (``events`` and
``registry``, ``obs``).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import socket
import subprocess
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from .policy import RetryPolicy, TrainingFailure
from .preempt import PREEMPT_EXIT_CODE

log = logging.getLogger(__name__)

MEMBERSHIP_FILE = "membership.json"
RESTORE_REQUEST_FILE = "restore_request.json"
HOST_REMESH_TOTAL = "host_remesh_total"
HOST_WORLD_GAUGE = "host_world_size"

# Env contract between the supervisor and its rank processes. The
# names are parallel/distributed's (detect_multihost); they are literals
# here so this module does not import the parallel package (and torch).
ENV_RANK = "JG_MH_RANK"
ENV_HOSTS = "JG_MH_HOSTS"
ENV_PORT = "JG_MH_PORT"
ENV_STORE = "JG_MH_STORE"


@dataclass
class HostMembershipView:
    """The supervisor's view of host-level membership, persisted to
    ``membership.json`` on the shared store after every transition so a
    restarted supervisor — or a post-incident reader — sees the world
    the checkpoint generations were written at.

    ``full_hosts`` is the launch world (``host_restore`` without an
    explicit count regrows to it); ``hosts`` is the current world;
    ``generation`` counts supervisor relaunches (every spawn, not just
    remeshes — forensics for "how many lives did this run use")."""

    full_hosts: int
    hosts: int
    generation: int = 0
    history: List[Dict[str, Any]] = field(default_factory=list)

    def record(self, store: str, **transition: Any) -> None:
        """Append a transition and atomically rewrite the view file."""
        if transition:
            self.history.append(
                {"generation": self.generation, **transition}
            )
        os.makedirs(store, exist_ok=True)
        path = os.path.join(store, MEMBERSHIP_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "full_hosts": self.full_hosts,
                    "hosts": self.hosts,
                    "generation": self.generation,
                    "history": self.history[-50:],
                },
                f, indent=2,
            )
        os.replace(tmp, path)  # atomic: readers never see a torn view


def read_membership(store: str) -> Optional[Dict[str, Any]]:
    """The persisted view, or None (missing/corrupt — a torn write is
    impossible by construction, but a foreign file is not)."""
    try:
        with open(os.path.join(store, MEMBERSHIP_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port. Each generation gets a fresh
    conductor port: the previous conductor may have died holding the
    old one, and survivors' half-closed sockets can linger in
    TIME_WAIT."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _signal_name(returncode: int) -> str:
    try:
        return signal.Signals(-returncode).name
    except ValueError:
        return f"signal {-returncode}"


def run_elastic_multihost(
    cmd: Sequence[str],
    *,
    hosts: int,
    store: str,
    policy: Optional[RetryPolicy] = None,
    env: Optional[Dict[str, str]] = None,
    events: Any = None,
    registry: Any = None,
    generation_timeout_s: Optional[float] = None,
    poll_s: float = 0.2,
    sleep=time.sleep,
) -> int:
    """Supervise ``cmd`` as an elastic ``hosts``-rank world.

    ``cmd`` is launched once per rank with the ``JG_MH_*`` env set
    (rank, world size, conductor port, shared ``store``); the command
    must run a resumable trainer (``--elastic --resume`` + a checkpoint
    dir on the shared store) so a relaunch continues instead of
    restarting. ``store`` also carries ``membership.json`` and the
    ``restore_request.json`` regrow handshake.

    ``events``: an optional obs EventLog/Telemetry-like with ``emit``;
    ``registry``: an optional obs MetricRegistry for the
    ``host_remesh_total`` counter and ``host_world_size`` gauge.
    ``generation_timeout_s`` bounds one generation's wall clock — a hung
    world is killed and classified transient.

    Returns 0 when every rank of a generation exits cleanly. Raises
    :class:`TrainingFailure` past the retry/preemption budget, or when
    the world shrinks below one host.
    """
    if hosts < 1:
        raise ValueError(f"hosts must be >= 1, got {hosts}")
    policy = policy if policy is not None else RetryPolicy()
    view = HostMembershipView(full_hosts=hosts, hosts=hosts)
    persisted = read_membership(store)
    if persisted and persisted.get("hosts"):
        # A supervisor restart mid-incident resumes at the persisted
        # world — the checkpoint generations were written at it.
        view.hosts = int(persisted["hosts"])
        view.generation = int(persisted.get("generation") or 0)
        view.history = list(persisted.get("history") or [])
    restarts = 0
    preemptions = 0

    def _emit(kind: str, **fields: Any) -> None:
        if events is not None:
            events.emit(kind, **fields)

    def _gauge() -> None:
        if registry is not None:
            registry.gauge(
                HOST_WORLD_GAUGE,
                "current multihost elastic world size (host count)",
            ).set(view.hosts)

    def _remesh_counter(direction: str) -> None:
        if registry is not None:
            registry.counter(
                HOST_REMESH_TOTAL,
                "multihost relaunches at a changed host count "
                "(label: direction=shrink|grow)",
            ).inc(direction=direction)

    view.record(store)
    while True:
        n = view.hosts
        port = _free_port()
        view.generation += 1
        view.record(store)
        _gauge()
        log.info(
            "launching multihost generation %d: %d host(s), "
            "conductor port %d", view.generation, n, port,
        )
        procs: List[subprocess.Popen] = []
        base_env = dict(os.environ)
        base_env.update(env or {})
        base_env[ENV_HOSTS] = str(n)
        base_env[ENV_PORT] = str(port)
        base_env[ENV_STORE] = store
        try:
            for rank in range(n):
                rank_env = dict(base_env)
                rank_env[ENV_RANK] = str(rank)
                procs.append(
                    subprocess.Popen(list(cmd), env=rank_env)
                )
        except OSError:
            for p in procs:
                p.kill()
            raise
        t0 = time.monotonic()
        timed_out = False
        while any(p.poll() is None for p in procs):
            if (
                generation_timeout_s is not None
                and time.monotonic() - t0 > generation_timeout_s
            ):
                timed_out = True
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                for p in procs:
                    p.wait()
                break
            sleep(poll_s)
        rcs = [p.returncode for p in procs]
        log.info(
            "generation %d exited: %s", view.generation,
            {r: rc for r, rc in enumerate(rcs)},
        )

        if timed_out:
            # Supervisor-killed ranks are NOT a host loss — classify the
            # hang as a transient failure below (budget consumed).
            restarts += 1
            if restarts > policy.max_restarts:
                raise TrainingFailure(
                    f"multihost generation hung past "
                    f"{generation_timeout_s}s {restarts} times; giving up"
                )
            delay = policy.backoff(restarts)
            _emit(
                "host_membership", event="timeout", hosts=n,
                generation=view.generation, budget_used=restarts,
                backoff_s=round(delay, 3),
            )
            log.warning(
                "generation %d hung (> %ss); killed, restarting at "
                "world %d in %.2fs (%d/%d)", view.generation,
                generation_timeout_s, n, delay, restarts,
                policy.max_restarts,
            )
            sleep(delay)
            continue

        if all(rc == 0 for rc in rcs):
            _emit(
                "host_membership", event="complete", hosts=n,
                generation=view.generation,
            )
            view.record(store, event="complete", hosts=n)
            return 0

        killed = [r for r, rc in enumerate(rcs) if rc < 0]
        if killed:
            survivors = n - len(killed)
            if survivors < 1:
                raise TrainingFailure(
                    f"all {n} host(s) killed "
                    f"({[_signal_name(rcs[r]) for r in killed]}); "
                    "nothing left to shrink to"
                )
            _remesh_counter("shrink")
            _emit(
                "host_membership", event="lost", direction="shrink",
                hosts_from=n, hosts_to=survivors, killed_ranks=killed,
                signals=[_signal_name(rcs[r]) for r in killed],
                generation=view.generation, budget_used=0,
            )
            log.warning(
                "host loss: rank(s) %s killed (%s) — relaunching at "
                "%d surviving host(s) from the newest verified "
                "checkpoint generation (retry budget untouched)",
                killed, ", ".join(_signal_name(rcs[r]) for r in killed),
                survivors,
            )
            view.hosts = survivors
            view.record(
                store, event="lost", hosts_from=n, hosts_to=survivors,
                killed_ranks=killed,
            )
            continue  # membership churn never burns the budget

        req_path = os.path.join(store, RESTORE_REQUEST_FILE)
        if any(rc == PREEMPT_EXIT_CODE for rc in rcs) and os.path.exists(
            req_path
        ):
            try:
                with open(req_path) as f:
                    req = json.load(f)
            except (OSError, ValueError):
                req = {}
            try:
                os.remove(req_path)  # consumed: a one-shot handshake
            except OSError:
                pass
            target = int(req.get("hosts") or view.full_hosts)
            if target == view.hosts:
                log.info(
                    "restore request for world %d: already there; "
                    "resuming", target,
                )
            else:
                direction = "grow" if target > view.hosts else "shrink"
                _remesh_counter(direction)
                _emit(
                    "host_membership", event="restored",
                    direction=direction, hosts_from=view.hosts,
                    hosts_to=target, generation=view.generation,
                    budget_used=0,
                )
                log.warning(
                    "host restore: relaunching at %d host(s) "
                    "(was %d; retry budget untouched)", target, view.hosts,
                )
                view.record(
                    store, event="restored", hosts_from=view.hosts,
                    hosts_to=target,
                )
                view.hosts = target
            continue

        if any(rc == PREEMPT_EXIT_CODE for rc in rcs):
            # A plain graceful vacate (SIGTERM, chaos preempt): resume
            # at the same world, counted against the preemption budget
            # exactly like run_with_policy would.
            preemptions += 1
            if preemptions > policy.max_preemptions:
                raise TrainingFailure(
                    f"preempted {preemptions} times; giving up"
                )
            _emit(
                "host_membership", event="preempted", hosts=n,
                generation=view.generation, budget_used=preemptions,
            )
            log.warning(
                "world vacated (exit %d); resuming at %d host(s) "
                "(%d/%d preemptions)", PREEMPT_EXIT_CODE, n,
                preemptions, policy.max_preemptions,
            )
            continue

        bad = {r: rc for r, rc in enumerate(rcs) if rc != 0}
        restarts += 1
        if restarts > policy.max_restarts:
            raise TrainingFailure(
                f"multihost training failed {restarts} times "
                f"(last exits: {bad}); giving up"
            )
        delay = policy.backoff(restarts)
        _emit(
            "host_membership", event="failed", hosts=n, exits=bad,
            generation=view.generation, budget_used=restarts,
            backoff_s=round(delay, 3),
        )
        log.warning(
            "generation %d failed (exits %s); restarting at world %d "
            "in %.2fs (%d/%d)", view.generation, bad, n, delay,
            restarts, policy.max_restarts,
        )
        sleep(delay)
