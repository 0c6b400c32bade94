"""The port's 1-bit gradient exchange (``ops/comm_compress.py``,
``train.optim.SignCompress``, ``interop.JaxFlatOrder``) against the JAX
package's.

The same numpy rows go through the JAX functions, under ``shard_map`` on
W of the 8 forced CPU devices, and through the port's in W gloo ranks
on the CPU (``parallel.spawn``; one spawn per world runs every case,
``tests/torch_dp_util.py``). Sign planes are bitwise equal; bucket
scales and the decoded values agree to rtol 1e-6: ``mean |x|`` over a
bucket sums in another order in XLA than in PyTorch, and jax 0.9.0's own
round trip is 1 ulp off (``tests/test_comm_compress.py::
test_compress_decompress_exact`` fails at seed). Where the phase-1 mean
cancels to near zero the atol is 1e-6 of the scale, as the JAX test's.
The wire bytes each rank's collectives counted equal ``CommPlan`` /
``HierPlan`` to the byte.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from jax.sharding import Mesh, PartitionSpec as P

from distributed_mnist_bnns_tpu.models import BnnMLP as JaxMLP
from distributed_mnist_bnns_tpu.ops import comm_compress as jcc
from distributed_mnist_bnns_tpu.parallel.compat import shard_map
from distributed_mnist_bnns_tpu.train.optim import (
    SignCompressState,
)
from distributed_mnist_bnns_tpu.train.optim import (
    sign_compress as jsign_compress,
)
from distributed_mnist_bnns_tpu_torch.interop import (
    JaxFlatOrder,
    params_from_jax,
)
from distributed_mnist_bnns_tpu_torch.ops import comm_compress as cc
from distributed_mnist_bnns_tpu_torch.parallel import spawn
from distributed_mnist_bnns_tpu_torch.train import SignCompress
from tests import torch_dp_util as util

RTOL = 1e-6
N, BUCKET, CHUNKS = 1000, 64, 2     # N: a partly padded last bucket
STEPS = 3


def _rows(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _plan_kw(world, mode):
    return dict(kind=None, n=N, world=world, mode=mode, bucket=BUCKET,
                chunks=CHUNKS)


def _jplan(world, mode):
    return jcc.make_plan(N, world=world, mode=mode, bucket_size=BUCKET,
                         chunks=CHUNKS)


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("data",))


def _jax_map(body, world, n_in, n_out, *args):
    f = shard_map(body, mesh=_mesh(world), in_specs=(P("data"),) * n_in,
                  out_specs=(P("data"),) * n_out, check_vma=False)
    return [np.asarray(o) for o in jax.jit(f)(*map(jnp.asarray, args))]


# -- the cases ----------------------------------------------------------------


def _exchange_cases(world):
    plan = _jplan(world, "sign_ef")
    e2 = _rows(11 + world, (world, plan.seg)) * 0.1
    return [
        dict(_plan_kw(world, "sign_ef"), kind="exchange",
             x=_rows(world, (world, plan.padded)), e2=e2),
        dict(_plan_kw(world, "sign"), kind="exchange",
             x=_rows(20 + world, (world, plan.padded))),
        dict(_plan_kw(world, "sign_ef"), kind="rs",
             x=_rows(30 + world, (world, plan.padded))),
        dict(_plan_kw(world, "sign"), kind="rs",
             x=_rows(40 + world, (world, plan.padded))),
        dict(_plan_kw(world, "sign_ef"), kind="ag",
             x=_rows(50 + world, (world, plan.seg))),
    ]


def _hier_case():
    hier = jcc.make_hier_plan(N, hosts=2, local=2, mode="sign_ef",
                              bucket_size=BUCKET, chunks=CHUNKS)
    x = _rows(60, (4, hier.inter.padded))
    x[:, N:] = 0.0                 # a padded gradient: zero past N
    return dict(kind="hier", n=N, hosts=2, local=2, mode="sign_ef",
                bucket=BUCKET, chunks=CHUNKS, x=x,
                e2=_rows(61, (2, hier.inter.seg)) * 0.1)


@functools.lru_cache(maxsize=None)
def _jax_template():
    model = JaxMLP(hidden=util.HIDDEN, dropout_rate=0.0, backend="xla")
    v = model.init({"params": jax.random.PRNGKey(0),
                    "dropout": jax.random.PRNGKey(1)},
                   jnp.zeros((2, 28, 28, 1)), train=True)
    return jax.tree.map(np.asarray, {"params": v["params"],
                                     "batch_stats": v["batch_stats"]})


def _port_grads(jax_grads):
    """Port-layout (out, in) gradients of flax-layout ones, by name."""
    out = {}
    model = util.transform_model()
    order = JaxFlatOrder(model)
    names = {id(p): n for n, p in model.named_parameters()}
    for path, p, tr in order.entries:
        mod, leaf = path.split("/")
        g = jax_grads[mod][leaf]
        out[names[id(p)]] = np.swapaxes(g, -1, -2).copy() if tr else g
    return out


def _transform_case(world, mode, hosts=None, seed=70):
    """Per step, per worker flax-layout gradients (JAX's input) and the
    same in the port's layout."""
    params = _jax_template()["params"]
    rng = np.random.RandomState(seed + world)
    jax_steps = [jax.tree.map(
        lambda p: rng.randn(world, *p.shape).astype(np.float32), params)
        for _ in range(STEPS)]
    case = dict(kind="transform", world=world, mode=mode, bucket=BUCKET,
                chunks=CHUNKS, hosts=hosts,
                grads=[_port_grads(g) for g in jax_steps])
    return case, jax_steps


@functools.lru_cache(maxsize=None)
def _cases(world):
    cases = _exchange_cases(world)
    tx = [_transform_case(world, "sign_ef"), _transform_case(world, "sign")]
    if world == 4:
        cases.append(_hier_case())
        tx.append(_transform_case(4, "sign_ef", hosts=2))
    return cases, tx


@functools.lru_cache(maxsize=None)
def _port(world):
    """Every case through ``world`` gloo ranks: per rank, per case."""
    cases, tx = _cases(world)
    return spawn(util.comm_rank, world, backend="gloo", device="cpu",
                 args=(cases + [c for c, _ in tx],))


# -- JAX's side ---------------------------------------------------------------


def _jax_exchange(case):
    world = case["world"]
    plan = _jplan(world, case["mode"])
    kind = case["kind"]
    if kind == "exchange":
        e2 = case.get("e2")

        def body(x, e):
            c, s, e2n = jcc.exchange(x[0], plan, axis_name="data",
                                     e2=None if e2 is None else e[0])
            return c[None], s[None], (jnp.zeros((1, 1)) if e2n is None
                                      else e2n[None])

        e_arg = np.zeros((world, plan.seg), np.float32) if e2 is None else e2
        out = _jax_map(body, world, 2, 3, case["x"], e_arg)
        return out if e2 is not None else out[:2] + [None]
    fn = (jcc.reduce_scatter_compressed if kind == "rs"
          else jcc.all_gather_compressed)

    def body(x):
        a, b = fn(x[0], plan, axis_name="data")
        return a[None], b[None]

    return _jax_map(body, world, 1, 2, case["x"])


def _jax_hier(case):
    hier = jcc.make_hier_plan(N, hosts=2, local=2, mode="sign_ef",
                              bucket_size=BUCKET, chunks=CHUNKS)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "local"))

    def body(x, e):
        c, s, e2n = jcc.hier_exchange(x[0], hier, host_axis="data",
                                      local_axis="local", e2=e[0])
        return c[None], s[None], e2n[None]

    f = shard_map(body, mesh=mesh,
                  in_specs=(P(("data", "local")), P("data")),
                  out_specs=(P(("data", "local")),) * 3, check_vma=False)
    out = jax.jit(f)(jnp.asarray(case["x"]), jnp.asarray(case["e2"]))
    return [np.asarray(o) for o in out]


def _jax_transform(world, mode, jax_steps, hosts=None):
    """JAX ``sign_compress`` under shard_map: per step, per worker (the
    flat update, ef_residual row, ef_residual2 row)."""
    params = _jax_template()["params"]
    exch = hosts or world
    if hosts:
        mesh = Mesh(np.array(jax.devices()[:world]).reshape(hosts, -1),
                    ("data", "local"))
        batch_axes, tx = ("data", "local"), jsign_compress(
            mode=mode, world=hosts, axis_name="data",
            local_axis_name="local", bucket_size=BUCKET, chunks=CHUNKS)
    else:
        mesh, batch_axes = _mesh(world), "data"
        tx = jsign_compress(mode=mode, world=world, axis_name="data",
                            bucket_size=BUCKET, chunks=CHUNKS)
    state = tx.init(params)
    plan = jcc.make_plan(jcc.tree_size(params), world=exch, mode=mode,
                         bucket_size=BUCKET, chunks=CHUNKS)
    if mode == "sign_ef":
        ef1, ef2 = state.ef_residual, state.ef_residual2
    else:
        ef1 = jnp.zeros((exch, 1))
        ef2 = jnp.zeros((exch, 1))

    def body(g, e1, e2):
        g = jax.tree.map(lambda a: a[0], g)
        st = SignCompressState(e1, e2) if mode == "sign_ef" else state
        upd, st = tx.update(g, st)
        flat = ravel_pytree(upd)[0][None]
        if mode == "sign_ef":
            return flat, st.ef_residual, st.ef_residual2
        return flat, e1, e2

    f = jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(P(batch_axes), P("data"), P("data")),
        out_specs=(P(batch_axes), P("data"), P("data")), check_vma=False))
    out = []
    for g in jax_steps:
        flat, ef1, ef2 = f(jax.tree.map(jnp.asarray, g), ef1, ef2)
        out.append((np.asarray(flat), np.asarray(ef1), np.asarray(ef2)))
    return out, plan


def _port_flat(update):
    """The port's per-name update laid out in the JAX flat order."""
    model = util.transform_model()
    named = dict(model.named_parameters())
    order = JaxFlatOrder(model)
    return order.flatten({named[k]: torch.from_numpy(v)
                          for k, v in update.items()}).numpy()


def _close(got, want, scale=None):
    atol = 0.0 if scale is None else RTOL * scale
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


# -- world 1: no collective ---------------------------------------------------


def test_compress_buckets_planes_bitwise_scales_rtol():
    x = _rows(1, (6, 5, 64))
    x[0, 0, :4] = [0.0, -0.0, 1e-40, -1e-40]     # zeros and subnormals
    jp, js = jcc.compress_buckets(jnp.asarray(x))
    tp, ts = cc.compress_buckets(torch.from_numpy(x))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    _close(ts.numpy(), np.asarray(js))
    _close(cc.decompress_buckets(tp, ts, 64).numpy(),
           np.asarray(jcc.decompress_buckets(jp, js, 64)))


@pytest.mark.parametrize("n,world,mode,bucket,chunks", [
    (1000, 1, "sign", 64, 2), (1000, 2, "sign_ef", 64, 2),
    (227914, 8, "sign", 1024, 4), (5000, 3, "fp32", 32, 3),
    (8330506, 4, "sign_ef", 1024, 4), (100, 4, "sign", 32, 7),
])
def test_plans_equal_jax(n, world, mode, bucket, chunks):
    kw = dict(world=world, mode=mode, bucket_size=bucket, chunks=chunks)
    jp, tp = jcc.make_plan(n, **kw), cc.make_plan(n, **kw)
    for f in ("mode", "world", "n_params", "bucket_size", "chunks", "nb",
              "padded", "seg", "words", "message_bytes",
              "fp32_bytes_per_step", "wire_bytes_rs", "wire_bytes_ag",
              "wire_bytes_per_step", "saved_bytes_per_step", "wire_ratio"):
        assert getattr(tp, f) == getattr(jp, f), f
    if mode != "fp32" and world % 2 == 0:
        kw.pop("world")
        jh = jcc.make_hier_plan(n, hosts=world // 2, local=2, **kw)
        th = cc.make_hier_plan(n, hosts=world // 2, local=2, **kw)
        for f in ("hosts", "world", "intra_bytes_per_step",
                  "inter_bytes_per_step", "flat_fp32_bytes_per_step",
                  "inter_ratio_vs_flat_fp32"):
            assert getattr(th, f) == getattr(jh, f), f


def test_plan_validation_raises_as_jax():
    for kw in (dict(mode="nope"), dict(mode="sign", bucket_size=48),
               dict(mode="sign", layout="ring")):
        with pytest.raises(ValueError):
            jcc.make_plan(100, world=2, **kw)
        with pytest.raises(ValueError):
            cc.make_plan(100, world=2, **kw)
    with pytest.raises(ValueError):
        cc.make_hier_plan(100, hosts=2, local=0, mode="sign")


@pytest.mark.parametrize("mode", ["sign", "sign_ef"])
def test_world1_exchange_matches_jax(mode):
    plan = _jplan(1, mode)
    x = _rows(2, (plan.padded,))
    e2 = _rows(3, (plan.seg,)) if mode == "sign_ef" else None
    want = jcc.exchange(jnp.asarray(x), plan, axis_name=None,
                        e2=None if e2 is None else jnp.asarray(e2))
    got = cc.exchange(torch.from_numpy(x), cc.make_plan(
        N, world=1, mode=mode, bucket_size=BUCKET, chunks=CHUNKS),
        group=None, e2=None if e2 is None else torch.from_numpy(e2))
    for k, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
        else:   # e2_new = y - recompressed y cancels: atol at unit scale
            _close(g.numpy(), np.asarray(w), scale=1.0 if k == 2 else None)


def test_pad_flat_and_tree_size():
    plan = cc.make_plan(100, world=2, mode="sign", bucket_size=32)
    x = torch.arange(100.0)
    padded = cc.pad_flat(x, plan)
    assert padded.shape == (plan.padded,)
    assert torch.equal(padded[:100], x) and padded[100:].abs().sum() == 0
    assert cc.tree_size([torch.zeros(3, 4), torch.zeros(5)]) == 17


@pytest.mark.parametrize("mode", ["sign", "sign_ef"])
def test_world1_transform_matches_jax_sign_compress(mode):
    """``SignCompress`` at world 1 against JAX ``sign_compress(world=1)``
    over three steps of the small MLP's gradients: the update (JAX flat
    order) and both residual rows."""
    case, jax_steps = _transform_case(1, mode)
    want, plan = _jax_transform(1, mode, jax_steps)
    model = util.transform_model()
    named = dict(model.named_parameters())
    tx = SignCompress(mode=mode, order=JaxFlatOrder(model),
                      bucket_size=BUCKET, chunks=CHUNKS)
    for s, grads in enumerate(case["grads"]):
        upd = tx(list(named.values()),
                 [torch.from_numpy(grads[k][0]) for k in named])
        got = JaxFlatOrder(model).flatten(dict(zip(named.values(), upd)))
        _close(got.numpy(), want[s][0][0])
        if mode == "sign_ef":
            st = tx.state_dict()
            _close(st["ef_residual"].numpy(), want[s][1][0], scale=1.0)
            _close(st["ef_residual2"].numpy(), want[s][2][0], scale=1.0)
        else:
            assert tx.state_dict() == {}


def test_world_gt_one_needs_a_group():
    model = util.transform_model()
    with pytest.raises(ValueError, match="requires a group"):
        SignCompress(mode="sign_ef", order=JaxFlatOrder(model), world=4)
    with pytest.raises(ValueError, match="requires group"):
        SignCompress(mode="sign", order=JaxFlatOrder(model),
                     local_group=object())
    with pytest.raises(ValueError, match="unknown compression mode"):
        SignCompress(mode="fp32", order=JaxFlatOrder(model))


@pytest.mark.parametrize("infl", [1, 3])
def test_jax_flat_order_is_ravel_pytree(infl):
    """``JaxFlatOrder.flatten`` of parameters carried across with
    ``params_from_jax`` is bitwise ``ravel_pytree`` of the flax params,
    at bnn-mlp-large widths too, and ``unflatten`` inverts it."""
    from distributed_mnist_bnns_tpu.models import bnn_mlp_large

    v = bnn_mlp_large(infl_ratio=infl, dropout_rate=0.0).init(
        {"params": jax.random.PRNGKey(infl), "dropout": jax.random.PRNGKey(0)},
        jnp.zeros((2, 28, 28, 1)), train=True)
    v = jax.tree.map(np.asarray, {"params": v["params"],
                                  "batch_stats": v["batch_stats"]})
    model = params_from_jax(v)
    order = JaxFlatOrder(model)
    want = np.asarray(ravel_pytree(v["params"])[0])
    got = order.flatten()
    assert order.n_params == want.size == jcc.tree_size(v["params"])
    np.testing.assert_array_equal(got.numpy(), want)
    back = order.unflatten(got)
    for _, p, _ in order.entries:
        assert torch.equal(back[p], p.detach())


# -- world 2 and 4: gloo ranks ------------------------------------------------


WORLDS = (2, 4)


def _wire_total(wire, level=None, phase=None):
    return sum(n for k, n in wire.items()
               if (level is None or k.startswith(level + "/"))
               and (phase is None or k.endswith("/" + phase)))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("i", range(5), ids=[
    "exchange-mean", "exchange-majority", "rs-mean", "rs-majority", "ag"])
def test_exchange_phases_match_jax(world, i):
    case = _cases(world)[0][i]
    want = _jax_exchange(case)
    port = _port(world)
    plan = _jplan(world, case["mode"])
    for rank in range(world):
        got = port[rank][i]["out"]
        for k, (g, w) in enumerate(zip(got, want)):
            if w is None:
                assert g is None
                continue
            # the phase-1 mean of 'rs' and e2_new = y - recompressed y
            # can cancel: atol at the inputs' unit scale
            cancels = case["kind"] == "rs" or k == 2
            _close(g, w[rank], scale=1.0 if cancels else None)
        if case["kind"] == "exchange":   # signs of the decodes: bitwise
            assert np.array_equal(got[0] > 0, want[0][rank] > 0)
            assert np.array_equal(got[1] > 0, want[1][rank] > 0)
            assert np.array_equal(got[0], port[0][i]["out"][0])
        wire = port[rank][i]["wire"]
        rs = plan.wire_bytes_rs if case["kind"] != "ag" else 0
        ag = plan.wire_bytes_ag if case["kind"] != "rs" else 0
        assert _wire_total(wire, phase="rs") == rs
        assert _wire_total(wire, phase="ag") == ag


def test_hier_exchange_matches_jax():
    case = _cases(4)[0][-1]
    want = _jax_hier(case)
    hier = jcc.make_hier_plan(N, hosts=2, local=2, mode="sign_ef",
                              bucket_size=BUCKET, chunks=CHUNKS)
    port = _port(4)
    for rank in range(4):
        got = port[rank][len(_cases(4)[0]) - 1]
        for g, w in zip(got["out"], want):
            _close(g, w[rank], scale=1.0)
        assert np.array_equal(got["out"][0] > 0, want[0][rank] > 0)
        wire = got["wire"]
        assert _wire_total(wire, level="intra") == hier.intra_bytes_per_step
        assert _wire_total(wire, level="inter") == hier.inter_bytes_per_step
        assert (_wire_total(wire, level="inter", phase="rs")
                == hier.inter.wire_bytes_rs)


@pytest.mark.parametrize("world,mode,hosts", [
    (2, "sign_ef", None), (2, "sign", None), (4, "sign_ef", None),
    (4, "sign", None), (4, "sign_ef", 2)],
    ids=["w2-sign_ef", "w2-sign", "w4-sign_ef", "w4-sign", "w4-hier"])
def test_transform_matches_jax_over_three_steps(world, mode, hosts):
    """``SignCompress`` in W ranks against JAX ``sign_compress`` under
    shard_map, three steps: every rank's update equal to JAX's (and to
    rank 0's, bitwise), the residual rows at rtol 1e-6 (atol 1e-6 of
    the gradients' unit scale, where a residual cancels), and the wire
    bytes of three steps equal to three times the plan's."""
    cases, tx = _cases(world)
    j = [k for k, (c, _) in enumerate(tx)
         if c["mode"] == mode and c["hosts"] == hosts][0]
    case, jax_steps = tx[j]
    want, plan = _jax_transform(world, mode, jax_steps, hosts=hosts)
    port = _port(world)
    idx = len(cases) + j
    local = world // hosts if hosts else 1
    for rank in range(world):
        got = port[rank][idx]
        row = rank // local
        for s in range(STEPS):
            flat = _port_flat(got["steps"][s]["update"])
            _close(flat, want[s][0][rank])
            assert np.array_equal(
                flat, _port_flat(port[0][idx]["steps"][s]["update"]))
            if mode == "sign_ef":
                st = got["steps"][s]["state"]
                _close(st["ef_residual"], want[s][1][row], scale=1.0)
                _close(st["ef_residual2"], want[s][2][row], scale=1.0)
        wire = got["wire"]
        assert _wire_total(wire, level="inter") == STEPS * \
            plan.wire_bytes_per_step
        if hosts:
            hp = jcc.make_hier_plan(plan.n_params, hosts=hosts, local=local,
                                    mode=mode, bucket_size=BUCKET,
                                    chunks=CHUNKS)
            assert _wire_total(wire, level="intra") == STEPS * \
                hp.intra_bytes_per_step
