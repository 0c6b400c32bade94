"""Processes, rendezvous and groups for data parallelism.

The torch counterpart of the JAX package's ``parallel/distributed.py``
and ``parallel/mesh.py::make_mesh``. The JAX package runs data
parallelism as one process over a device mesh; here each rank is a
process (the reference's DDP layout, ``mnist-dist2.py:83,93``):

  init_world(rank, world, backend=, init_file= | coordinator=)
                                  join the process group
  spawn(fn, world, backend=, device=[, coordinator=, nodes=, node_rank=])
                                  run ``fn`` in ``world`` ranks (of this
                                  node), return their results (device
                                  None: the card)
  make_groups(hosts, local)       the 'data' group and, for the
                                  hierarchical exchange, this rank's
                                  in-host and inter-host groups (built
                                  once per world)

The backend is always the caller's: ``"nccl"`` on the card, one rank per
card (``spawn`` raises when ``world`` exceeds the cards, as ``make_mesh``
does with too few devices; NCCL refuses two ranks on one card);
``"gloo"`` on the CPU. Ranks that share a card run over gloo only when
the caller asks for it with ``backend="gloo", device="cuda"``.

On one node the rendezvous is a ``file://`` in a fresh temporary
directory, so concurrent runs (parallel test workers) never meet on a
port. Across nodes (the reference's ``mnist-dist2.py -n 2 -g 1 -nr
{0,1}``) each node starts its ``local`` ranks and all of them meet at
``tcp://<coordinator>``: rank ``node_rank * local + i``, world ``nodes *
local`` (mnist-dist2.py:40-43,82). Rank 0 holds the ``TCPStore`` on the
coordinator's port. The bootstrap is the JAX ``initialize_multihost``'s:
the config is checked before any network IO (``check_multihost_config``,
a ``ValueError``), each attempt is bounded by ``init_timeout`` (rank 0's
store waits that long for the others; another rank first waits that long
for the coordinator's port to answer, since the store's client retries
on its own for about twice its timeout, and the process group's timeout
bounds only its collectives on some versions), the process group is
joined inside the attempt (a rank that met a rank 0 which then timed out
meets the next one), failures are classified (``classify_init_error``:
coordinator-unreachable, rank-collision, timeout, unknown), the
retryable kinds are retried with ``RetryPolicy``'s jittered backoff, and
then ``MultihostInitError`` is raised: a rank never carries on alone. A
rank collision (two processes on rank 0's port) is fatal at once.

``detect_multihost`` reads the ``JG_MH_*`` environment that the
multihost elastic supervisor (``resilience.multihost``) exports into
each rank process: there every host is one process outside any process
group, and the inter-host exchange travels over the host collective
(``parallel.hostcomm``).
"""

from __future__ import annotations

import datetime
import gc
import logging
import os
import pickle
import signal
import socket
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

log = logging.getLogger(__name__)

BACKENDS = ("nccl", "gloo")

# Environment contract between the elastic multihost supervisor and its
# rank subprocesses (resilience/multihost.py exports, detect_multihost
# reads). RANK/HOSTS name the host-level world; PORT is the rank-0
# conductor port for the host collective; STORE is the shared directory
# (checkpoints + membership.json + events).
ENV_RANK = "JG_MH_RANK"
ENV_HOSTS = "JG_MH_HOSTS"
ENV_PORT = "JG_MH_PORT"
ENV_STORE = "JG_MH_STORE"


#: classification kinds (``MultihostInitError.kind``)
COORDINATOR_UNREACHABLE = "coordinator-unreachable"
RANK_COLLISION = "rank-collision"
TIMEOUT = "timeout"
UNKNOWN = "unknown"

# substring -> kind, matched case-insensitively against the message
_UNREACHABLE_PATTERNS = (
    "connection refused", "unavailable", "failed to connect",
    "connection reset", "name or service not known", "unreachable",
)
_COLLISION_PATTERNS = (
    "already exists", "already_exists", "duplicate task",
    "duplicate process", "already connected", "task already",
    "address already in use",
)
_TIMEOUT_PATTERNS = (
    "deadline exceeded", "deadline_exceeded", "timed out", "timeout",
    "barrier timed out",
)


class MultihostInitError(RuntimeError):
    """The multi-node rendezvous failed; ``kind`` is its classification
    (coordinator-unreachable, rank-collision, timeout, unknown)."""

    def __init__(self, message: str, *, kind: str, attempts: int = 1):
        super().__init__(message)
        self.kind = kind
        self.attempts = attempts


def classify_init_error(exc: BaseException) -> str:
    """The kind of a rendezvous failure: by exception type first, then by
    the message."""
    if isinstance(exc, ConnectionError):
        return COORDINATOR_UNREACHABLE
    if isinstance(exc, TimeoutError):
        return TIMEOUT
    msg = str(exc).lower()
    for kind, patterns in ((RANK_COLLISION, _COLLISION_PATTERNS),
                           (COORDINATOR_UNREACHABLE, _UNREACHABLE_PATTERNS),
                           (TIMEOUT, _TIMEOUT_PATTERNS)):
        if any(pat in msg for pat in patterns):
            return kind
    return UNKNOWN


def _split_address(address: str):
    host, sep, port = address.rpartition(":")
    if not sep or not host:
        raise ValueError(f"coordinator address must be 'host:port', got "
                         f"{address!r}")
    try:
        port_n = int(port)
    except ValueError:
        raise ValueError(f"coordinator port {port!r} is not an integer"
                         ) from None
    if not 1 <= port_n <= 65535:
        raise ValueError(f"coordinator port {port_n} out of range 1..65535")
    return host, port_n


def check_multihost_config(coordinator_address: Optional[str],
                           num_processes: Optional[int],
                           process_id: Optional[int]) -> None:
    """Checks before any network IO, as ``ValueError`` (fatal to the
    retry policy): a world of several processes needs a coordinator and
    an explicit rank in ``[0, num_processes)``, and the coordinator is
    ``host:port``."""
    if num_processes is not None and num_processes < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes}")
    if num_processes is not None and num_processes > 1:
        if coordinator_address is None:
            raise ValueError(f"num_processes={num_processes} needs a "
                             "coordinator_address (host:port)")
        if process_id is None:
            raise ValueError(f"num_processes={num_processes} needs an "
                             "explicit process_id (this process's rank)")
    if process_id is not None:
        if process_id < 0:
            raise ValueError(f"process_id must be >= 0, got {process_id}")
        if num_processes is not None and process_id >= num_processes:
            raise ValueError(
                f"process_id {process_id} out of range for num_processes "
                f"{num_processes} (ranks are 0..{num_processes - 1})")
    if coordinator_address is not None:
        _split_address(coordinator_address)


def detect_multihost(env: Optional[Dict[str, str]] = None) -> Optional[dict]:
    """Read the elastic supervisor's ``JG_MH_*`` rank environment.

    Returns ``{"rank", "hosts", "port", "store"}`` when this process
    was launched as a rank of a multihost world, else ``None``. Raises
    ``ValueError`` on a half-set or inconsistent environment — a rank
    that silently ran single-host would corrupt the shared checkpoint
    generations it shares with its peers.
    """
    env = os.environ if env is None else env
    rank_s = env.get(ENV_RANK)
    hosts_s = env.get(ENV_HOSTS)
    if rank_s is None and hosts_s is None:
        return None
    if rank_s is None or hosts_s is None:
        raise ValueError(
            f"half-set multihost env: {ENV_RANK}={rank_s!r} "
            f"{ENV_HOSTS}={hosts_s!r} (supervisor must export both)"
        )
    try:
        rank, hosts = int(rank_s), int(hosts_s)
    except ValueError:
        raise ValueError(
            f"non-integer multihost env: {ENV_RANK}={rank_s!r} "
            f"{ENV_HOSTS}={hosts_s!r}"
        ) from None
    if hosts < 1 or not 0 <= rank < hosts:
        raise ValueError(
            f"multihost env rank {rank} out of range for {hosts} host(s)"
        )
    port_s = env.get(ENV_PORT)
    info = {
        "rank": rank,
        "hosts": hosts,
        "port": int(port_s) if port_s is not None else None,
        "store": env.get(ENV_STORE),
    }
    if hosts > 1 and info["port"] is None:
        raise ValueError(
            f"{ENV_HOSTS}={hosts} needs {ENV_PORT} (rank-0 conductor "
            "port for the host collective)"
        )
    return info


def _with_retries(connect: Callable[[], Any], rank: int, world: int,
                  coordinator: str, *, retries: int, policy=None,
                  sleep: Callable[[float], None] = time.sleep):
    """``connect()`` with the bootstrap's retry rule: a rank collision
    fails at once, the other kinds are retried ``retries`` times with
    ``RetryPolicy``'s jittered backoff (seeded from the rank), then
    ``MultihostInitError``."""
    if policy is None:
        from ..resilience.policy import RetryPolicy

        policy = RetryPolicy(max_restarts=retries, base_backoff_s=0.5,
                             max_backoff_s=15.0, seed=rank)
    attempts = 0
    while True:
        attempts += 1
        try:
            return connect()
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            kind = classify_init_error(e)
            desc = (f"rendezvous attempt {attempts} failed [{kind}] "
                    f"(coordinator {coordinator}, rank {rank}/{world}): "
                    f"{type(e).__name__}: {e}")
            if kind == RANK_COLLISION:
                raise MultihostInitError(desc, kind=kind,
                                         attempts=attempts) from e
            if attempts > retries:
                raise MultihostInitError(
                    f"{desc}; the budget of {retries} retries is spent",
                    kind=kind, attempts=attempts) from e
            delay = policy.backoff(attempts)
            log.warning("%s; retrying in %.2fs", desc, delay)
            sleep(delay)


def _await_coordinator(host: str, port: int, timeout_s: float) -> None:
    """Return once ``host:port`` accepts a connection; raise within
    ``timeout_s`` otherwise (``ConnectionRefusedError`` when it kept
    refusing). The store's client retries on its own for about twice its
    timeout, so this is what bounds a rank's attempt."""
    deadline = time.monotonic() + timeout_s
    while True:
        left = deadline - time.monotonic()
        try:
            with socket.create_connection((host, port),
                                          timeout=min(max(left, 0.05), 1.0)):
                return
        except OSError as e:
            if time.monotonic() + 0.1 >= deadline:
                kind = (ConnectionRefusedError
                        if isinstance(e, ConnectionRefusedError)
                        else TimeoutError)
                raise kind(f"no coordinator answered at {host}:{port} "
                           f"within {timeout_s} s ({e})") from e
            time.sleep(0.1)


def _store(rank: int, world: int, coordinator: str, init_timeout: float):
    host, port = _split_address(coordinator)
    if rank != 0:
        _await_coordinator(host, port, init_timeout)
    return dist.TCPStore(host, port, world_size=world, is_master=rank == 0,
                         timeout=datetime.timedelta(seconds=init_timeout),
                         wait_for_workers=True)


def tcp_store(rank: int, world: int, coordinator: str, *,
              init_timeout: float = 60.0, retries: int = 3, policy=None,
              sleep: Callable[[float], None] = time.sleep):
    """The ``TCPStore`` of ``world`` ranks at ``coordinator`` (rank 0 holds
    it and waits for the others), each attempt bounded by
    ``init_timeout`` seconds, retried as ``_with_retries`` says."""
    check_multihost_config(coordinator, world, rank)
    return _with_retries(
        lambda: _store(rank, world, coordinator, init_timeout), rank, world,
        coordinator, retries=retries, policy=policy, sleep=sleep)


def _rank_device(backend: str, device: str, local: int) -> torch.device:
    """The device of a node's rank ``local``: ``cuda:local`` under NCCL,
    the cards in turn under gloo on ``"cuda"``, else the CPU."""
    if device == "cpu":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", local)
    return torch.device("cuda", local % torch.cuda.device_count())


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
               init_file: Optional[str] = None,
               coordinator: Optional[str] = None,
               init_timeout: float = 60.0, init_retries: int = 3,
               local: Optional[int] = None) -> None:
    """Join the default process group as ``rank`` of ``world`` over
    ``backend``, meeting at ``file://init_file`` or, across nodes, at
    ``tcp://coordinator`` (``tcp_store``). Under NCCL the rank takes card
    ``local`` (default ``rank``)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (have: nccl, gloo)")
    if (init_file is None) == (coordinator is None):
        raise ValueError("give one of init_file and coordinator")
    if backend == "nccl":
        torch.cuda.set_device(rank if local is None else local)
    if coordinator is not None:
        # The process group joins inside the retry: a rank that met a
        # rank 0 which then timed out (a peer missing) loses that store
        # and must meet the next one.
        check_multihost_config(coordinator, world, rank)
        _with_retries(lambda: dist.init_process_group(
            backend, store=_store(rank, world, coordinator, init_timeout),
            rank=rank, world_size=world), rank, world, coordinator,
            retries=init_retries)
        return
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)


def _release_world() -> None:
    """Destroy the default process group and every group this module and
    ``parallel.mesh`` cached from it, then collect the garbage, so that
    each process group is destructed (and its gloo threads joined) while
    the interpreter is whole.

    ``destroy_process_group`` alone frees no group that Python still
    holds: ``make_groups``' and the mesh's caches hold theirs, and a
    trainer in a reference cycle holds the default group until a
    collection. Such a group outlived the rank's function into the
    interpreter's exit with its gloo threads running, and the rank then
    aborted now and then after its result was sent ("terminate called
    without an active exception", SIGABRT), failing the spawn."""
    from . import mesh

    dist.destroy_process_group()
    _GROUPS.clear()
    mesh._GROUPS.clear()
    gc.collect()


#: the last bytes of a rank's stderr that a failure reports
STDERR_TAIL_BYTES = 4096


def _entry(local: int, fn: Callable, world: int, backend: str, device: str,
           meet: Dict[str, Any], results, args: tuple) -> None:
    # this rank's stderr goes to a file the parent copies to its own
    # stderr as it grows, and whose tail it reports if the rank fails
    fd = os.open(os.path.join(meet["stderr_dir"], f"{local}.stderr"),
                 os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o600)
    os.dup2(fd, 2)
    os.close(fd)
    rank = meet.get("node_rank", 0) * meet.get("local", 0) + local
    init_world(rank, world, backend=backend, init_file=meet.get("init_file"),
               coordinator=meet.get("coordinator"),
               init_timeout=meet.get("init_timeout", 60.0),
               init_retries=meet.get("init_retries", 3), local=local)
    try:
        dev = _rank_device(backend, device, local)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        out = fn(rank, world, dev, *args)
    finally:
        _release_world()
    # by value: a tensor shared through a file descriptor would vanish
    # with this process
    results.put((rank, pickle.dumps(out)))


class _StderrTee:
    """The parent's side of the ranks' stderr files: ``pump`` copies what
    they gained to this process's stderr and keeps each file's last
    ``STDERR_TAIL_BYTES``."""

    def __init__(self, directory: str, world: int):
        self.paths = [os.path.join(directory, f"{i}.stderr")
                      for i in range(world)]
        self.offsets = [0] * world
        self.tails = [b""] * world

    def pump(self) -> None:
        for i, path in enumerate(self.paths):
            try:
                with open(path, "rb") as f:
                    f.seek(self.offsets[i])
                    data = f.read()
            except FileNotFoundError:
                continue
            if not data:
                continue
            self.offsets[i] += len(data)
            self.tails[i] = (self.tails[i] + data)[-STDERR_TAIL_BYTES:]
            sys.stderr.write(data.decode("utf-8", "replace"))
        sys.stderr.flush()

    def tail(self, local: int) -> str:
        return self.tails[local].decode("utf-8", "replace").rstrip()


class RankFailed(RuntimeError):
    """A spawned world failed: ``exits`` maps each rank at fault to its
    process's exit code (negative: the signal that ended it; None: still
    running); the message carries, for each, how it ended (a raising
    rank's traceback comes first) and the last lines of its stderr."""

    def __init__(self, message: str, exits: Dict[int, Optional[int]]):
        super().__init__(message)
        self.exits = exits


def _how_it_ended(code: Optional[int]) -> str:
    """How a rank's process ended, from its exit code (a timeout, or a
    rank whose result never came)."""
    if code is None:
        return "still running (stopped by spawn)"
    if code < 0:
        try:
            return f"killed by signal {signal.Signals(-code).name}"
        except ValueError:
            return f"killed by signal {-code}"
    return f"exited with code {code}"


def _failure(what: str, ranks: List[int], procs, tee: _StderrTee,
             focus: List[int], ended: Optional[str] = None) -> RankFailed:
    """``what`` happened: each rank of ``focus`` (of this node's
    ``ranks``) with how its process ended (``ended`` where the caller
    knows it, else read from its exit code) and its stderr tail."""
    codes = {r: p.exitcode for r, p in zip(ranks, procs.processes)}
    lines = [what]
    for r in focus:
        local = ranks.index(r)
        lines.append(f"rank {r} (pid {procs.processes[local].pid}) "
                     f"{ended or _how_it_ended(codes[r])}; "
                     "the end of its stderr:")
        tail = tee.tail(local)
        lines.append("\n".join("    " + ln for ln in tail.splitlines())
                     if tail else "    (empty)")
    return RankFailed("\n".join(lines), {r: codes[r] for r in focus})


def _forward_sigterm(processes) -> Callable[[], Any]:
    """Pass SIGTERM on to ``processes``; returns what puts the previous
    handler back (nothing is installed outside the main thread)."""
    def forward(signum, frame):
        for p in processes:
            if p.is_alive():
                os.kill(p.pid, signum)

    try:
        previous = signal.signal(signal.SIGTERM, forward)
    except ValueError:   # not the main thread
        return lambda: None
    return lambda: signal.signal(
        signal.SIGTERM, signal.SIG_DFL if previous is None else previous)


def spawn(fn: Callable, world: int, *, backend: str,
          device: Optional[str] = None, args: tuple = (),
          timeout_s: float = 1800.0, coordinator: Optional[str] = None,
          nodes: int = 1, node_rank: int = 0, init_timeout: float = 60.0,
          init_retries: int = 3) -> List[Any]:
    """Run ``fn(rank, world, device, *args)`` in ``world`` fresh processes
    joined in one process group; return their results in rank order.
    ``device`` None means ``"cuda"``, which raises without a card: the
    ranks run on the CPU only when the caller passes ``device="cpu"``.

    With ``coordinator`` ("host:port") this call is node ``node_rank`` of
    ``nodes``: it starts its ``world`` ranks as ranks ``node_rank * world
    + i`` of ``nodes * world`` (``fn`` sees that world), which meet the
    other nodes' at ``tcp://coordinator`` (``init_timeout`` a try,
    ``init_retries`` retries), and returns the results of its own ranks.

    While the ranks run, a SIGTERM sent to this process (called from the
    main thread) is passed on to each of them, so that a trainer's
    graceful stop sees it (``cli train --dp``). SIGINT is not: Ctrl-C
    reaches the whole process group already, and a second SIGINT turns a
    graceful stop into ``KeyboardInterrupt``.

    ``fn`` must be importable (it is pickled by name) and its result
    picklable (move tensors to the CPU). A rank that raises or dies
    fails the call with ``RankFailed``, which names how each failed rank
    ended (its traceback, exit code or signal) beside the end of its
    stderr, and the other ranks are stopped; so are all of them at
    ``timeout_s`` (a ``TimeoutError`` with the same report). Each rank's
    stderr is copied to this process's stderr as the ranks run."""
    device = "cuda" if device is None else device
    check_world(world, backend=backend, device=device)
    if coordinator is None and nodes != 1:
        raise ValueError(f"nodes={nodes} needs a coordinator (host:port)")
    if coordinator is not None:
        check_multihost_config(coordinator, nodes * world, node_rank * world)
    ranks = [node_rank * world + i for i in range(world)]
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        meet: Dict[str, Any] = (
            {"init_file": os.path.join(tmp, "rendezvous")}
            if coordinator is None else
            {"coordinator": coordinator, "node_rank": node_rank,
             "local": world, "init_timeout": init_timeout,
             "init_retries": init_retries})
        meet["stderr_dir"] = tmp
        tee = _StderrTee(tmp, world)
        procs = mp.start_processes(
            _entry, args=(fn, nodes * world, backend, device, meet, results,
                          args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        restore_sigterm = _forward_sigterm(procs.processes)
        try:
            while True:
                while not results.empty():
                    rank, out = results.get()
                    got[rank] = pickle.loads(out)
                tee.pump()
                try:
                    if procs.join(timeout=0.05):
                        break
                except (mp.ProcessRaisedException,
                        mp.ProcessExitedException) as e:
                    tee.pump()
                    ended = ("raised (its traceback above)"
                             if isinstance(e, mp.ProcessRaisedException)
                             else f"killed by signal {e.signal_name}"
                             if e.signal_name
                             else f"exited with code {e.exit_code}")
                    raise _failure(f"{world} ranks: {e}", ranks, procs,
                                   tee, [ranks[e.error_index]], ended) from e
                if time.monotonic() > deadline:
                    tee.pump()
                    raise TimeoutError(str(_failure(
                        f"{world} ranks still running after {timeout_s} s",
                        ranks, procs, tee, ranks)))
        finally:
            restore_sigterm()
            for p in procs.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
            tee.pump()
        while not results.empty():
            rank, out = results.get()
            got[rank] = pickle.loads(out)
        missing = sorted(set(ranks) - set(got))
        if missing:
            raise _failure(f"ranks {missing} returned no result", ranks,
                           procs, tee, focus=missing)
    return [got[r] for r in ranks]


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


# (id of the default group, world, hosts, local) -> Groups; the entry
# holds the default group, so its id is not reused while it is cached
_GROUPS: Dict[tuple, Groups] = {}


def make_groups(hosts: Optional[int] = None,
                local: Optional[int] = None) -> Groups:
    """The groups of this rank (every rank must call it, in the same
    order). Without ``hosts`` the layout is flat. The groups of a layout
    are built once per default process group: a trainer rebuilt in the
    same world (``run_with_policy``, a second run in one process) gets
    the same groups, and NCCL sets up no new communicators."""
    world, rank = dist.get_world_size(), dist.get_rank()
    data = dist.group.WORLD
    if hosts is None:
        return Groups(data=data)
    local = world // hosts if local is None else local
    if hosts * local != world:
        raise ValueError(f"{hosts} hosts x {local} local != world {world}")
    key = (id(data), world, hosts, local)
    if key in _GROUPS and _GROUPS[key].data is data:
        return _GROUPS[key]
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
    for stale in [k for k, g in _GROUPS.items() if g.data is not data]:
        del _GROUPS[stale]   # layouts of a destroyed default group
    _GROUPS[key] = Groups(data=data,
                          local=mine_local if local > 1 else None,
                          inter=mine_inter if hosts > 1 else None, host=host)
    return _GROUPS[key]
