"""Expert parallelism of the PyTorch port (``parallel.expert_parallel``):
4 gloo ranks on the CPU (one spawn, a 2-rank subgroup inside) against
the port's and the JAX package's dense ``moe_reference`` with the same
per-shard routing, and against the JAX ``make_expert_parallel_moe`` on
the forced CPU mesh. The rank side is ``tests/torch_moe_util.py``.

Routing is held exactly (each token's top gates carry a margin of at
least 1e-4, asserted). Outputs are ±1 sums scaled by gates: atol and
rtol 1e-5, JAX's own test's; gradients through the two all-to-alls
(the backward is the same exchange of the cotangent) atol and rtol
1e-4, JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from distributed_mnist_bnns_tpu.parallel import expert_parallel as jep
from distributed_mnist_bnns_tpu_torch.parallel import (
    expert_parallel as tep,
)
from distributed_mnist_bnns_tpu_torch.parallel import spawn
from tests import torch_moe_util as util

WORLD = 4
CASES = {  # name -> (t, d, d_out, e, capacity, k, ranks)
    "no_drops": (64, 16, 24, 8, 16, 1, (0, 1, 2, 3)),
    "drops": (64, 16, 24, 8, 2, 1, (0, 1, 2, 3)),
    "top2": (64, 16, 24, 8, 4, 2, (0, 1, 2, 3)),
    "two_rank_subset": (16, 16, 24, 4, 8, 1, (0, 1)),
}
MARGIN = 1e-4


def _setup(seed, t, d, d_out, e):
    rng = np.random.RandomState(seed)
    scale = d ** -0.5
    params = {"w": rng.uniform(-scale, scale, (e, d, d_out)).astype(
        np.float32), "b": rng.randn(e, d_out).astype(np.float32) * 0.5}
    gate_w = (rng.randn(d, e) * 0.5).astype(np.float32)
    x = rng.randn(t, d).astype(np.float32)
    return params, gate_w, x


def _margin_ok(gate_w, x, n, k):
    for xs in np.split(x, n):
        g = torch.softmax(torch.from_numpy(xs @ gate_w), -1).numpy()
        s = -np.sort(-g, axis=-1)
        if min((s[:, 0] - s[:, 1]).min(), (s[:, k - 1] - s[:, k]).min()) \
                <= MARGIN:
            return False
    return True


@functools.lru_cache(maxsize=None)
def _inputs(name):
    t, d, d_out, e, capacity, k, ranks = CASES[name]
    seed = 0
    while True:   # the first seed whose routing has a margin
        params, gate_w, x = _setup(seed, t, d, d_out, e)
        if _margin_ok(gate_w, x, len(ranks), k):
            return params, gate_w, x
        seed += 1


@pytest.fixture(scope="module")
def ranks():
    cases = [(*_inputs(n), CASES[n][4], CASES[n][5], CASES[n][6])
             for n in CASES]
    return spawn(util.ep_run, WORLD, backend="gloo", device="cpu",
                 args=(cases,), timeout_s=300.0)


def _port_reference(name):
    """The port's dense oracle: output and the gradients of the sum of
    squares."""
    params, gate_w, x = _inputs(name)
    _, _, _, _, capacity, k, rks = CASES[name]
    p = {key: torch.from_numpy(v.copy()).requires_grad_(True)
         for key, v in params.items()}
    g = torch.from_numpy(gate_w.copy()).requires_grad_(True)
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    y = tep.moe_reference(p, g, xt, capacity=capacity, n_shards=len(rks),
                          k=k)
    (y ** 2).sum().backward()
    return y.detach().numpy(), {"w": p["w"].grad.numpy(),
                                "b": p["b"].grad.numpy(),
                                "gate_w": g.grad.numpy(),
                                "x": xt.grad.numpy()}


def _jax_reference(name):
    params, gate_w, x = _inputs(name)
    _, _, _, _, capacity, k, rks = CASES[name]

    def f(p, g, xx):
        return jep.moe_reference(p, g, xx, capacity=capacity,
                                 n_shards=len(rks), k=k)

    jp = jax.tree.map(jnp.asarray, params)
    y = f(jp, jnp.asarray(gate_w), jnp.asarray(x))
    gp, gg, gx = jax.grad(lambda *a: jnp.sum(f(*a) ** 2), argnums=(0, 1, 2))(
        jp, jnp.asarray(gate_w), jnp.asarray(x))
    return np.asarray(y), {"w": np.asarray(gp["w"]),
                           "b": np.asarray(gp["b"]),
                           "gate_w": np.asarray(gg), "x": np.asarray(gx)}


def test_top1_dispatch_respects_capacity():
    gates = torch.softmax(torch.from_numpy(
        np.random.RandomState(0).randn(32, 4).astype(np.float32)), -1)
    dispatch, combine = tep.top1_dispatch(gates, 3)
    assert tuple(dispatch.shape) == (32, 4, 3)
    assert (dispatch.sum(dim=(0, 2)) <= 3).all()
    per_token = dispatch.sum(dim=(1, 2))
    assert set(per_token.tolist()) <= {0.0, 1.0}
    kept = per_token == 1.0
    np.testing.assert_allclose(combine.sum(dim=(1, 2))[kept].numpy(),
                               gates.max(dim=-1).values[kept].numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_reference_equals_jax_reference(name):
    """The port's ``moe_reference`` (per-shard routing, the dense oracle)
    against JAX's: output and every gradient."""
    y, grads = _port_reference(name)
    jy, jgrads = _jax_reference(name)
    np.testing.assert_allclose(y, jy, atol=1e-5, rtol=1e-5)
    for key in grads:
        np.testing.assert_allclose(grads[key], jgrads[key], atol=1e-4,
                                   rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("name", sorted(CASES))
def test_expert_parallel_matches_oracle_forward_and_gradients(name, ranks):
    """The ranks' rows, concatenated, equal the dense oracle (the port's
    and JAX's); the gradients summed over the group equal the oracle's;
    a token count the group does not divide raises."""
    rks = CASES[name][6]
    got = [ranks[r][list(CASES).index(name)] for r in rks]
    y = np.concatenate([g["out"] for g in got])
    want, wgrads = _port_reference(name)
    jy, _ = _jax_reference(name)
    np.testing.assert_allclose(y, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y, jy, atol=1e-5, rtol=1e-5)
    for key, g in got[0]["grads"].items():
        np.testing.assert_allclose(g, wgrads[key], atol=1e-4, rtol=1e-4,
                                   err_msg=key)
        assert np.abs(g).sum() > 0, key
    assert all(g["raises_on_indivisible"] for g in got)
    outside = [ranks[r][list(CASES).index(name)]
               for r in range(WORLD) if r not in rks]
    assert all(o is None for o in outside)


def test_jax_expert_parallel_agrees_on_the_same_inputs():
    """JAX's shard_map deployment over 4 CPU devices gives what the port's
    4 ranks give (both equal the oracle; checked here directly)."""
    params, gate_w, x = _inputs("top2")
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("expert",))
    moe = jep.make_expert_parallel_moe(mesh, capacity=CASES["top2"][4], k=2)
    got = np.asarray(moe(jax.tree.map(jnp.asarray, params),
                         jnp.asarray(gate_w), jnp.asarray(x)))
    want, _ = _port_reference("top2")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
