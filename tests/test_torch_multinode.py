"""The multi-node launch (``parallel/distributed.py``): ranks of several
"nodes" meeting at ``tcp://<coordinator>``, as the reference's
``mnist-dist2.py -n 2 -g 1 -nr {0,1}`` and the JAX
``initialize_multihost``.

Two nodes of 2 gloo ranks each (two ``spawn`` calls with one
coordinator on loopback: rank ``node_rank * 2 + i`` of 4) run 3
``sign_ef`` steps of ``bnn-mlp-small`` flat and with ``dp_hosts=2``; the
final states (params, batch stats, optimizer state, every worker's
error feedback) are bitwise those of one 4-rank ``spawn`` over a
``file://`` rendezvous. One launch per world, module-scoped. A rank
whose coordinator never answers raises ``MultihostInitError`` within
``init_timeout x (retries + 1)`` plus the backoff; a second rank 0 on
the coordinator's port is a rank collision, fatal at once; bad configs
fail before any network IO; the groups of a layout are built once per
world; ``spawn`` passes SIGTERM on to its ranks.
"""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch.distributed as dist

from distributed_mnist_bnns_tpu_torch import cli
from distributed_mnist_bnns_tpu_torch.parallel import (
    MultihostInitError,
    check_multihost_config,
    classify_init_error,
    spawn,
    tcp_store,
)
from distributed_mnist_bnns_tpu_torch.parallel import distributed as D
from distributed_mnist_bnns_tpu_torch.resilience import RetryPolicy
from tests import torch_dp_util as util

CFG = dict(model="bnn-mlp-small", model_kwargs={"infl_ratio": 1},
           batch_size=32, data_parallel=4, grad_compress="sign_ef",
           compress_bucket_size=1024, compress_chunks=2, seed=1)
HOSTS = [None, 2]
STEPS = 3


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def one_spawn():
    return spawn(util.steps_state_run, 4, backend="gloo", device="cpu",
                 args=(CFG, HOSTS, STEPS))


@pytest.fixture(scope="module")
def two_nodes():
    coordinator = f"127.0.0.1:{_free_port()}"
    out = {}

    def node(rank):
        out[rank] = spawn(util.steps_state_run, 2, backend="gloo",
                          device="cpu", args=(CFG, HOSTS, STEPS),
                          coordinator=coordinator, nodes=2, node_rank=rank,
                          init_timeout=60.0)

    t = threading.Thread(target=node, args=(1,))
    t.start()
    node(0)
    t.join(timeout=300)
    return out[0] + out[1]


@pytest.mark.parametrize("hosts", HOSTS, ids=["flat", "dp-hosts-2"])
def test_two_nodes_over_tcp_equal_one_four_rank_spawn(one_spawn, two_nodes,
                                                      hosts):
    assert len(two_nodes) == len(one_spawn) == 4
    for rank, (a, b) in enumerate(zip(one_spawn, two_nodes)):
        a, b = a[str(hosts)], b[str(hosts)]
        assert a.keys() == b.keys() and a
        for k in a:
            assert np.array_equal(a[k], b[k]), (rank, k)
    ef = one_spawn[0][str(hosts)]["opt_state/inner_state/0/ef_residual"]
    assert ef.shape[0] == (4 if hosts is None else 2)
    assert np.abs(ef).sum() > 0


def test_unanswered_coordinator_fails_within_its_bound():
    timeout, retries = 1.0, 1
    policy = RetryPolicy(max_restarts=retries, base_backoff_s=0.2,
                         max_backoff_s=0.2, seed=0)
    t0 = time.monotonic()
    with pytest.raises(MultihostInitError) as ei:
        tcp_store(1, 2, f"127.0.0.1:{_free_port()}", init_timeout=timeout,
                  retries=retries, policy=policy)
    elapsed = time.monotonic() - t0
    assert ei.value.attempts == retries + 1
    assert ei.value.kind in (D.TIMEOUT, D.COORDINATOR_UNREACHABLE)
    assert elapsed <= timeout * (retries + 1) + 0.2 * retries + 2.0
    assert not dist.is_initialized()


def test_second_rank_zero_is_a_fatal_collision():
    port = _free_port()
    holder = dist.TCPStore("127.0.0.1", port, world_size=2, is_master=True,
                           wait_for_workers=False)
    try:
        t0 = time.monotonic()
        with pytest.raises(MultihostInitError) as ei:
            tcp_store(0, 2, f"127.0.0.1:{port}", init_timeout=5.0,
                      retries=3)
        assert ei.value.kind == D.RANK_COLLISION and ei.value.attempts == 1
        assert time.monotonic() - t0 < 5.0
    finally:
        del holder


@pytest.mark.parametrize("args,match", [
    (("127.0.0.1:29500", 0, 0), "num_processes must be >= 1"),
    ((None, 2, 0), "needs a coordinator"),
    (("127.0.0.1:29500", 2, None), "explicit process_id"),
    (("127.0.0.1:29500", 2, 2), "out of range"),
    (("127.0.0.1:29500", 2, -1), ">= 0"),
    (("localhost", 2, 0), "host:port"),
    (("127.0.0.1:http", 2, 0), "not an integer"),
    (("127.0.0.1:70000", 2, 0), "out of range 1..65535"),
])
def test_bad_configs_fail_before_any_network_io(args, match):
    with pytest.raises(ValueError, match=match):
        check_multihost_config(*args)


@pytest.mark.parametrize("exc,kind", [
    (ConnectionRefusedError("no"), D.COORDINATOR_UNREACHABLE),
    (TimeoutError("slow"), D.TIMEOUT),
    (RuntimeError("EADDRINUSE: address already in use"), D.RANK_COLLISION),
    (RuntimeError("The client socket has timed out after 1000ms"),
     D.TIMEOUT),
    (RuntimeError("Connection refused by peer"), D.COORDINATOR_UNREACHABLE),
    (RuntimeError("something else"), D.UNKNOWN),
])
def test_classify_init_error(exc, kind):
    assert classify_init_error(exc) == kind


def test_cli_node_flags():
    args = cli.build_parser().parse_args([
        "train", "--dp", "4", "--nodes", "2", "--node-rank", "1",
        "--coordinator", "10.0.0.1:29500", "--init-timeout", "5",
        "--init-retries", "1", "--device", "cpu"])
    assert cli._local_ranks(args) == 2
    assert (args.nodes, args.node_rank, args.coordinator) == (
        2, 1, "10.0.0.1:29500")
    args.dp = "3"
    with pytest.raises(SystemExit, match="multiple of --nodes"):
        cli._local_ranks(args)
    with pytest.raises(ValueError, match="needs a coordinator"):
        spawn(util.steps_state_run, 1, backend="gloo", device="cpu",
              nodes=2)


def test_make_groups_builds_a_layout_once_per_world(monkeypatch, tmp_path):
    """A second trainer of the same world gets the same groups: no new
    communicators. A world of one rank (gloo, in this process) is enough
    to see the cache."""
    calls = []
    real = dist.new_group
    monkeypatch.setattr(dist, "new_group",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        g1 = D.make_groups(1)
        n = len(calls)
        assert D.make_groups(1) is g1 and len(calls) == n == 2
    finally:
        dist.destroy_process_group()
        D._GROUPS.clear()


def test_spawn_passes_sigterm_on_to_its_ranks():
    """SIGTERM to the launching process reaches each rank (a trainer's
    graceful stop), and the previous handler comes back."""
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(60)"])

    class Rank:
        pid = child.pid

        def is_alive(self):
            return child.poll() is None

    before = signal.getsignal(signal.SIGTERM)
    restore = D._forward_sigterm([Rank()])
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert child.wait(timeout=30) == -signal.SIGTERM
    finally:
        restore()
        if child.poll() is None:
            child.kill()
    assert signal.getsignal(signal.SIGTERM) == before
