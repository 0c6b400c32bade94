"""The port's multihost elastic runtime against the JAX package's: the
host collective (``parallel/hostcomm.py``), ``detect_multihost``, the
host 1-bit exchange, the supervisor (``resilience/multihost.py``) and
the trainer's multihost world.

* ``HostChannel``: a 3-rank allgather in rank order (the port's
  conductor with JAX's peers too: the frames are the same bytes), the
  conductor attributing a closed peer to its rank, a tag divergence
  latching ``lost``.
* ``HostSignCompress`` against JAX's ``host_sign_compress`` on the same
  numpy gradients of 3 hosts (a channel that hands each host the
  others' messages): the sign planes bitwise, the scales within 1e-6
  relative, the combined update and the error feedback within 1e-6.
* The per-host EF rows fold 2 -> 1 and regrow 1 -> 2 as JAX's
  ``remesh_compress_state`` folds them (tests/test_multihost_elastic.py).
* The supervisor's classification table: JAX's scripted rank commands
  (clean world, a killed rank, every rank killed, preemption and
  transient budgets, the restore handshake) give the same
  ``host_membership`` records and ``membership.json`` under both
  supervisors.
* A real 2-host CPU run of ``cli train`` through ``host_lost`` (shrink
  to 1) and ``host_restore`` (regrow to 2) ends bitwise equal to fresh
  runs at each host count from the same checkpoint generations.
* The trainer's refusals under ``JG_MH_*`` as JAX raises them.
"""

import json
import os
import socket
import sys
import threading

import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu.parallel import distributed as jdist
from distributed_mnist_bnns_tpu.parallel import hostcomm as jhost
from distributed_mnist_bnns_tpu.resilience import RetryPolicy as JRetry
from distributed_mnist_bnns_tpu.resilience import multihost as jsup
from distributed_mnist_bnns_tpu_torch.parallel import distributed as pdist
from distributed_mnist_bnns_tpu_torch.parallel import hostcomm as phost
from distributed_mnist_bnns_tpu_torch.resilience import (
    RetryPolicy,
    TrainingFailure,
)
from distributed_mnist_bnns_tpu_torch.resilience import multihost as psup


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world(mods, port, timeout_s=10.0):
    """Channels of ranks 0..n-1 (``mods[r]`` the module of rank r), all
    started (the conductor accepts while the peers connect)."""
    chans = [m.HostChannel(r, len(mods), port, timeout_s=timeout_s)
             for r, m in enumerate(mods)]
    threads = [threading.Thread(target=c.start) for c in chans]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return chans


def _gather_all(chans, payloads, tags):
    out = [None] * len(chans)

    def run(r):
        try:
            out[r] = chans[r].allgather(payloads[r], tag=tags[r])
        except Exception as e:   # noqa: BLE001 - recorded for the test
            out[r] = e

    threads = [threading.Thread(target=run, args=(r,))
               for r in range(len(chans))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return out


@pytest.mark.parametrize("peers", ["port", "jax"])
def test_allgather_in_rank_order(peers):
    peer = phost if peers == "port" else jhost
    chans = _world([phost, peer, peer], _port())
    try:
        for step in range(3):
            payloads = [f"rank{r}-step{step}".encode() * (r + 1)
                        for r in range(3)]
            out = _gather_all(chans, payloads, [step] * 3)
            assert out == [payloads] * 3
        rows = _gather_all(chans, [np.full(4, r, np.float32).tobytes()
                                   for r in range(3)], [9] * 3)
        assert rows[0][2] == np.full(4, 2, np.float32).tobytes()
        assert chans[0].bytes_received > 0 and chans[1].bytes_sent > 0
    finally:
        for c in chans:
            c.close()


def test_conductor_attributes_a_lost_peer():
    chans = _world([phost] * 3, _port(), timeout_s=5.0)
    try:
        chans[2].close()      # host 2 dies
        out = _gather_all(chans[:2], [b"a", b"b"], [0, 0])
        assert isinstance(out[0], phost.HostLostError)
        assert out[0].lost_ranks == [2] and chans[0].lost_ranks == [2]
        assert chans[0].lost and "host 2 lost" in chans[0].lost_reason
        assert isinstance(out[1], phost.HostLostError) or chans[1].lost
        with pytest.raises(phost.HostLostError, match="already lost"):
            chans[0].allgather(b"x", tag=1)
    finally:
        for c in chans:
            c.close()


def test_tag_divergence_latches_lost():
    chans = _world([phost] * 2, _port(), timeout_s=5.0)
    try:
        out = _gather_all(chans, [b"a", b"b"], [0, 7])
        assert isinstance(out[0], phost.HostLostError)
        assert "schedule divergence" in chans[0].lost_reason
        assert chans[0].lost
    finally:
        for c in chans:
            c.close()


def test_one_host_needs_no_socket():
    ch = phost.HostChannel(0, 1, 0).start()
    assert ch.allgather(b"x") == [b"x"]
    rows = phost.allgather_rows(ch, np.arange(3, dtype=np.float32))
    assert rows.shape == (1, 3)
    with pytest.raises(ValueError):
        phost.HostChannel(2, 2, 0)


@pytest.mark.parametrize("env", [
    {},
    {"JG_MH_RANK": "1", "JG_MH_HOSTS": "3", "JG_MH_PORT": "4242",
     "JG_MH_STORE": "/s"},
    {"JG_MH_RANK": "0", "JG_MH_HOSTS": "1"},
    {"JG_MH_RANK": "0"},
    {"JG_MH_RANK": "x", "JG_MH_HOSTS": "2"},
    {"JG_MH_RANK": "3", "JG_MH_HOSTS": "2", "JG_MH_PORT": "1"},
    {"JG_MH_RANK": "0", "JG_MH_HOSTS": "2"},
])
def test_detect_multihost_equals_jax(env):
    try:
        want = jdist.detect_multihost(env)
    except ValueError as j:
        with pytest.raises(ValueError) as e:
            pdist.detect_multihost(env)
        assert str(e.value) == str(j)
        return
    assert pdist.detect_multihost(env) == want
    assert (pdist.ENV_RANK, pdist.ENV_HOSTS, pdist.ENV_PORT,
            pdist.ENV_STORE) == (psup.ENV_RANK, psup.ENV_HOSTS,
                                 psup.ENV_PORT, psup.ENV_STORE)


# -- the host 1-bit exchange ---------------------------------------------------


class _FlatOrder:
    """A one-leaf stand-in for ``interop.JaxFlatOrder``."""

    def __init__(self, p):
        self.p = p
        self.entries = [("w", p, True)]
        self.n_params = p.numel()

    def flatten(self, grads):
        return grads[self.p].reshape(-1)

    def unflatten(self, flat):
        return {self.p: flat.reshape(self.p.shape)}


class _Channel:
    """Host ``rank`` of ``hosts``: records its message and answers with
    ``bundle`` (the others' messages, its own in place)."""

    def __init__(self, rank, hosts, bundle=None):
        self.rank, self.hosts, self.lost = rank, hosts, False
        self.bundle, self.sent = bundle, None

    def allgather(self, payload, tag=0):
        self.sent = payload
        parts = list(self.bundle or [payload] * self.hosts)
        parts[self.rank] = payload
        return parts

    def mark_lost(self, reason, ranks=None):
        self.lost = True


def _jax_tx(mode, ch, n, bucket):
    return jhost.host_sign_compress(mode=mode, channel=ch,
                                    bucket_size=bucket, chunks=2)


def _split(payload, nb, words):
    planes = np.frombuffer(payload[:nb * words * 4], np.int32)
    return planes, np.frombuffer(payload[nb * words * 4:], np.float32)


@pytest.mark.parametrize("mode", ["sign", "sign_ef"])
def test_host_sign_compress_equals_jax(mode):
    import jax
    import jax.numpy as jnp

    hosts, n, bucket, steps = 3, 1000, 64, 2
    rng = np.random.RandomState(0)
    grads = rng.randn(steps, hosts, n).astype(np.float32)
    ports, jaxs, pstate, jstate = [], [], [], []
    for r in range(hosts):
        p = torch.nn.Parameter(torch.zeros(n))
        pt = phost.HostSignCompress(mode=mode, order=_FlatOrder(p),
                                    channel=_Channel(r, hosts),
                                    bucket_size=bucket, chunks=2)
        jt = _jax_tx(mode, _Channel(r, hosts), n, bucket)
        ports.append((p, pt))
        jaxs.append(jt)
        jstate.append(jt.init(jnp.zeros(n)))
    plan = ports[0][1].plan
    nb = hosts * plan.nb
    for s in range(steps):
        # pass 1: every host's message; pass 2: combine the bundle
        msgs_p, msgs_j = [], []
        for r in range(hosts):
            p, pt = ports[r]
            pt.channel.bundle = None
            pt.step_tag = s
            saved = None if pt.ef_residual is None else pt.ef_residual.clone()
            pt([p], [torch.from_numpy(grads[s, r])])
            if saved is not None:
                pt.ef_residual.copy_(saved)
            msgs_p.append(pt.channel.sent)
            jt = jaxs[r]
            ch = _Channel(r, hosts)
            jt2 = _jax_tx(mode, ch, n, bucket)
            jax.block_until_ready(jt2.update(jnp.asarray(grads[s, r]),
                                             jstate[r]))
            msgs_j.append(ch.sent)
        for mp, mj in zip(msgs_p, msgs_j):
            pp, ps = _split(mp, nb, plan.words)
            jp, js = _split(mj, nb, plan.words)
            np.testing.assert_array_equal(pp, jp)
            np.testing.assert_allclose(ps, js, rtol=1e-6, atol=0)
        for r in range(hosts):
            p, pt = ports[r]
            pt.channel.bundle = msgs_j
            upd = pt([p], [torch.from_numpy(grads[s, r])])[0]
            ch = _Channel(r, hosts, bundle=msgs_j)
            jt2 = _jax_tx(mode, ch, n, bucket)
            jupd, jstate[r] = jt2.update(jnp.asarray(grads[s, r]), jstate[r])
            np.testing.assert_allclose(upd.numpy(), np.asarray(jupd),
                                       rtol=1e-6, atol=1e-7)
            if mode == "sign_ef":
                np.testing.assert_allclose(
                    pt.ef_residual.numpy(),
                    np.asarray(jstate[r].ef_residual)[r], rtol=1e-6,
                    atol=1e-6)
                assert not pt.ef_residual2.any()


def test_host_exchange_never_raises_and_latches_lost():
    p = torch.nn.Parameter(torch.zeros(100))

    class Dead(_Channel):
        def allgather(self, payload, tag=0):
            raise phost.HostLostError("peer closed mid-frame")

    tx = phost.HostSignCompress(mode="sign_ef", order=_FlatOrder(p),
                                channel=Dead(0, 2), bucket_size=32)
    upd = tx([p], [torch.ones(100)])[0]
    assert tx.channel.lost and not upd.any()


def _plan(world, n_params=5000):
    from distributed_mnist_bnns_tpu_torch.ops.comm_compress import make_plan

    return make_plan(n_params, world=world, mode="sign_ef", bucket_size=256,
                     chunks=2)


@pytest.mark.parametrize("old,new", [(2, 1), (1, 2)])
def test_host_ef_rows_fold_as_jax(old, new):
    from distributed_mnist_bnns_tpu.parallel.remesh import (
        remesh_compress_state as jremesh,
    )
    from distributed_mnist_bnns_tpu.train.optim import SignCompressState
    from distributed_mnist_bnns_tpu_torch.parallel.remesh import (
        remesh_compress_state,
    )

    po, pn = _plan(old), _plan(new)
    rng = np.random.RandomState(old)
    ef = rng.randn(old, po.padded).astype(np.float32)
    ef[:, po.n_params:] = 0.0
    ef2 = np.zeros((old, po.seg), np.float32)   # the host exchange's
    got, n = remesh_compress_state(
        {"0": {"ef_residual": ef, "ef_residual2": ef2}}, pn)
    want, m = jremesh((SignCompressState(ef_residual=ef,
                                         ef_residual2=ef2),), pn)
    assert n == m == 1
    np.testing.assert_array_equal(got["0"]["ef_residual"],
                                  np.asarray(want[0].ef_residual))
    np.testing.assert_array_equal(got["0"]["ef_residual2"],
                                  np.asarray(want[0].ef_residual2))


# -- the supervisor --------------------------------------------------------------

_KILL_LAST_RANK_ONCE = r"""
import os, signal, sys
rank, hosts = int(os.environ["JG_MH_RANK"]), int(os.environ["JG_MH_HOSTS"])
if hosts == 2 and rank == 1:
    os.kill(os.getpid(), signal.SIGKILL)
sys.exit(0)
"""
_KILL_ALL = r"""
import os, signal
os.kill(os.getpid(), signal.SIGKILL)
"""
_FLAG_THEN_OK = r"""
import os, sys
flag = os.path.join(os.environ["JG_MH_STORE"], "flag")
if not os.path.exists(flag):
    open(flag, "w").close()
    sys.exit(int(sys.argv[1]))
sys.exit(0)
"""
_RESTORE_REQUEST = r"""
import json, os, sys
store = os.environ["JG_MH_STORE"]
if os.environ["JG_MH_HOSTS"] == "1":
    with open(os.path.join(store, "restore_request.json"), "w") as f:
        json.dump({"hosts": 2}, f)
    sys.exit(75)
sys.exit(0)
"""
_RANK_ONE_FLAG_THEN_OK = r"""
import os, sys
flag = os.path.join(os.environ["JG_MH_STORE"], "flag")
if os.environ["JG_MH_RANK"] == "1" and not os.path.exists(flag):
    open(flag, "w").close()
    sys.exit(int(sys.argv[1]))
sys.exit(0)
"""
_RANK_ONE_ONLY = r"""
import os, sys
sys.exit(3 if os.environ["JG_MH_RANK"] == "1" else 0)
"""


class _Events:
    def __init__(self):
        self.rows = []

    def emit(self, kind, **f):
        self.rows.append({"kind": kind, **f})


def _run(mod, store, src, *argv, policy, shrunk=False):
    os.makedirs(store, exist_ok=True)
    if shrunk:
        mod.HostMembershipView(full_hosts=2, hosts=1).record(store)
    ev = _Events()
    try:
        rc = mod.run_elastic_multihost(
            [sys.executable, "-c", src, *map(str, argv)], hosts=2,
            store=store, events=ev, poll_s=0.02, sleep=lambda s: None,
            policy=policy)
    except Exception as e:   # noqa: BLE001 - compared across supervisors
        rc = (type(e).__name__, str(e))
    rows = [{k: v for k, v in r.items() if k != "backoff_s"}
            for r in ev.rows]
    view = mod.read_membership(store)
    return rc, rows, view


CASES = [
    ("clean", "import sys; sys.exit(0)", (), (0, 0), False),
    ("kill_last", _KILL_LAST_RANK_ONCE, (), (0, 0), False),
    ("kill_all", _KILL_ALL, (), (0, 0), False),
    ("preempt_ok", _FLAG_THEN_OK, (75,), (0, 1), False),
    ("preempt_spent", _FLAG_THEN_OK, (75,), (0, 0), False),
    ("transient_ok", _RANK_ONE_FLAG_THEN_OK, (3,), (1, 0), False),
    ("transient_spent", _RANK_ONE_ONLY, (), (1, 0), False),
    ("restore", _RESTORE_REQUEST, (), (0, 0), True),
]


@pytest.mark.parametrize("name,src,argv,budget,shrunk", CASES,
                         ids=[c[0] for c in CASES])
def test_supervisor_classification_equals_jax(tmp_path, name, src, argv,
                                              budget, shrunk):
    restarts, preempts = budget
    got = _run(psup, str(tmp_path / "port"), src, *argv, shrunk=shrunk,
               policy=RetryPolicy(max_restarts=restarts,
                                  max_preemptions=preempts,
                                  base_backoff_s=0.0))
    want = _run(jsup, str(tmp_path / "jax"), src, *argv, shrunk=shrunk,
                policy=JRetry(max_restarts=restarts,
                              max_preemptions=preempts, base_backoff_s=0.0))
    assert got == want
    if name == "kill_last":
        assert got[1][0]["event"] == "lost" and got[2]["hosts"] == 1
    if name == "restore":
        assert not os.path.exists(tmp_path / "port" / "restore_request.json")


def test_supervisor_rejects_empty_world(tmp_path):
    with pytest.raises(ValueError, match="hosts"):
        psup.run_elastic_multihost(["true"], hosts=0, store=str(tmp_path))
    assert TrainingFailure.__mro__[1] is RuntimeError


# -- the trainer under JG_MH_* ---------------------------------------------------


def _mh_env(monkeypatch, rank=0, hosts=1, port=None):
    monkeypatch.setenv("JG_MH_RANK", str(rank))
    monkeypatch.setenv("JG_MH_HOSTS", str(hosts))
    if port is not None:
        monkeypatch.setenv("JG_MH_PORT", str(port))


REFUSALS = [
    dict(grad_compress="none"),
    dict(grad_compress="sign_ef", dp_hosts=2),
    dict(grad_compress="sign", dp_mode="fsdp"),
    dict(grad_compress="sign_ef", hosts=2),
]


@pytest.mark.parametrize("i", range(len(REFUSALS)))
def test_multihost_refusals_as_jax(monkeypatch, tmp_path, i):
    from distributed_mnist_bnns_tpu.train import trainer as jtrainer
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    kw = dict(REFUSALS[i])
    _mh_env(monkeypatch, hosts=kw.pop("hosts", 1), port=_port())
    cfg = dict(model="bnn-mlp-small", model_kwargs={"infl_ratio": 1},
               batch_size=32, checkpoint_dir=str(tmp_path), **kw)
    with pytest.raises(ValueError) as j:
        jtrainer.Trainer(jtrainer.TrainConfig(**cfg))
    with pytest.raises(ValueError) as e:
        Trainer(TrainConfig(device="cpu", **cfg))
    assert str(e.value) == str(j.value)


def test_one_host_world_trains_and_refuses_capture(monkeypatch, tmp_path):
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    _mh_env(monkeypatch)
    t = Trainer(TrainConfig(
        model="bnn-mlp-small", model_kwargs={"infl_ratio": 1},
        batch_size=32, device="cpu", grad_compress="sign_ef", scan_steps=2,
        backend="xla", checkpoint_dir=str(tmp_path), epochs=1))
    assert t.host_channel is not None and t.comm_plan.world == 1
    assert "host TCP sockets" in t._get_train_scan().refuse
    rows = t.ef_rows()
    assert rows["ef_residual"].shape == (1, t.comm_plan.padded)


# -- a real 2-host run -------------------------------------------------------------


def _cmd(ck, epochs, chaos=None):
    cmd = [sys.executable, "-m", "distributed_mnist_bnns_tpu_torch.cli",
           "train", "--model", "bnn-mlp-small", "--infl-ratio", "1",
           "--epochs", str(epochs), "--synthetic-sizes", "256", "64",
           "--batch-size", "64", "--device", "cpu", "--backend", "xla",
           "--grad-compress", "sign_ef", "--elastic", "--resume",
           "--checkpoint-dir", ck,
           "--data-dir", os.path.join(ck, "none"), "--log-interval", "1",
           "--no-preemption"]
    return cmd + (["--chaos", chaos] if chaos else [])


def _final(ck):
    from distributed_mnist_bnns_tpu_torch.utils import msgpack

    with open(os.path.join(ck, "checkpoint.msgpack"), "rb") as f:
        return msgpack.from_bytes(f.read())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def test_two_hosts_shrink_and_regrow_bitwise_a_fresh_resume(tmp_path):
    """host_lost at step 2 (rank 1 SIGKILLed, rank 0 vacates unsaved;
    the world restarts at 1 host from scratch), host_restore at step 6
    (epoch 1's boundary saves; 2 hosts resume epoch 2). The reference:
    1 host for 2 epochs, then 2 hosts resumed for the third."""
    env = {"PYTHONPATH": os.getcwd(), "JAX_PLATFORMS": "cpu"}
    store = str(tmp_path / "store")
    ck = os.path.join(store, "ck")
    ev = _Events()
    rc = psup.run_elastic_multihost(
        _cmd(ck, 3, "host_lost@step=2,hosts=1;host_restore@step=6"),
        hosts=2, store=store, env=env, events=ev, poll_s=0.05,
        generation_timeout_s=240)
    assert rc == 0
    assert [r["event"] for r in ev.rows] == ["lost", "restored",
                                             "complete"]
    view = psup.read_membership(store)
    assert [(h["event"], h.get("hosts_from"), h.get("hosts_to"))
            for h in view["history"]] == [("lost", 2, 1),
                                          ("restored", 1, 2),
                                          ("complete", None, None)]
    ref_store = str(tmp_path / "ref")
    ref_ck = os.path.join(ref_store, "ck")
    assert psup.run_elastic_multihost(_cmd(ref_ck, 2), hosts=1,
                                      store=ref_store, env=env) == 0
    # a second world, not a restarted supervisor of the first
    os.remove(os.path.join(ref_store, "membership.json"))
    assert psup.run_elastic_multihost(_cmd(ref_ck, 3), hosts=2,
                                      store=ref_store, env=env) == 0
    got, want = dict(_leaves(_final(ck))), dict(_leaves(_final(ref_ck)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["/step"]) == 12
