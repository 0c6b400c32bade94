"""The port's GPipe schedule (``parallel/pipeline.py``) and the three-axis
composition (``parallel/tp_pipeline.py``) against the JAX package's.

The port runs in 2 and 4 gloo ranks on the CPU (``parallel.spawn``,
module-scoped: one spawn per world runs every case,
``tests/torch_mp_util.py``); the JAX side on its forced CPU devices, on
the same numpy parameters and inputs:
  * the binarized residual stage chain pipelined for several
    ``(n_stages, n_micro)`` against the JAX ``sequential_reference`` and
    the JAX pipeline (exact up to fp32 rounding: atol 1e-5), and the
    gradient of sum(y^2) against ``jax.grad`` of the sequential chain
    (atol 1e-4 of sums up to ~100);
  * ``stage_remat`` bitwise the plain pipeline, output and gradient;
  * a stage that draws (``stage_takes_rng``) bitwise its rng-matched
    oracle ``sequential_reference_rng`` (the draws are torch's, not
    JAX's ``fold_in`` stream: the contract is schedule invariance);
  * DP x PP: each data row's pipeline equals the sequential chain on its
    rows;
  * ``make_tp_pipeline_fn`` at (data 1, model 2, pipe 2) against the JAX
    ``tp_pipeline_reference``: the forward (1e-5 of its scale) and 5 SGD
    steps (losses rtol 1e-5; each rank's parameter slices to the JAX TP
    test's atol 1e-3: the row-parallel sums reassociate, and a latent
    within rounding of 0 takes either sign; measured 5.1e-4);
  * ``pipeline_bubble_fraction`` equal to JAX's; the meshes' layouts
    (``make_mesh`` row-major as JAX's, ``make_hybrid_mesh``) and groups.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_mnist_bnns_tpu.ops import binarize as j_binarize
from distributed_mnist_bnns_tpu.parallel import pipeline as jpipe
from distributed_mnist_bnns_tpu.parallel import tp_pipeline as jtpp
from distributed_mnist_bnns_tpu_torch.parallel import (
    make_mesh,
    pipeline_bubble_fraction,
    spawn,
)
from tests import torch_mp_util as util

D = 16
CASES = {2: [(2, False), (6, False), (2, True)],
         4: [(4, False), (8, False), (4, True)]}
TPP = dict(d_model=16, d_hidden=32, batch=8, steps=5, lr=0.05)


def _j_stage(params, x):
    w = j_binarize(params["w"])
    return x + jnp.clip(jnp.dot(j_binarize(x), w), -1.0, 1.0)


def _params(n_stages, seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.uniform(-1, 1, (n_stages, D, D)).astype(np.float32)}


def _x(n_micro, seed):
    return np.random.RandomState(seed).randn(n_micro * 4, D).astype(
        np.float32)


def _tpp_inputs():
    rng = np.random.RandomState(11)
    s = 1.0 / TPP["d_model"] ** 0.5
    params = {
        "w1": rng.uniform(-s, s, (2, TPP["d_model"], TPP["d_hidden"])),
        "b1": rng.randn(2, TPP["d_hidden"]) * 0.1,
        "w2": rng.uniform(-s, s, (2, TPP["d_hidden"], TPP["d_model"])),
        "b2": rng.randn(2, TPP["d_model"]) * 0.1,
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.randn(TPP["batch"], TPP["d_model"]).astype(np.float32)
    target = rng.randn(TPP["batch"], TPP["d_model"]).astype(np.float32)
    return params, x, target


@functools.lru_cache(maxsize=None)
def _port(world):
    cases = [(n_micro, _params(world, world + n_micro), _x(n_micro, n_micro),
              "grad", remat) for n_micro, remat in CASES[world]]
    rng_cases = [(world, _params(world, 5), _x(world, 6), "rng", r)
                 for r in (False, True)]
    jobs = [("pipe", "pipeline_run", (cases + rng_cases,))]
    if world == 4:
        jobs.append(("dp", "dp_pipeline_run",
                     (_params(2, 3), _x(4, 9), 2)))
        jobs.append(("tpp", "tp_pipeline_run",
                     (*_tpp_inputs(), TPP["steps"], TPP["lr"])))
        jobs.append(("mesh", "mesh_run", ()))
    return spawn(util.jobs_rank, world, backend="gloo", device="cpu",
                 args=(jobs,))


@pytest.fixture(scope="module")
def port():
    return _port


def _jax_case(world, n_micro):
    params, x = _params(world, world + n_micro), _x(n_micro, n_micro)
    oracle = jpipe.sequential_reference(params, x, _j_stage)
    grad = jax.grad(lambda p: (jpipe.sequential_reference(
        p, x, _j_stage) ** 2).sum())(params)
    return np.asarray(oracle), np.asarray(grad["w"])


@pytest.mark.parametrize("world,i", [(2, 0), (2, 1), (4, 0), (4, 1)])
def test_pipeline_matches_sequential_and_jax(port, world, i):
    n_micro, _ = CASES[world][i]
    want_y, want_g = _jax_case(world, n_micro)
    for rank in port(world):
        got = rank["pipe"][i]
        np.testing.assert_allclose(got["y"], want_y, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["grad"], want_g, atol=1e-4, rtol=0)


def test_pipeline_matches_the_jax_pipeline(port):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("pipe",))
    params, x = _params(4, 8), _x(4, 4)
    want = jpipe.make_pipeline_fn(mesh, _j_stage, n_micro=4)(params, x)
    np.testing.assert_allclose(port(4)[0]["pipe"][0]["y"], np.asarray(want),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("world", [2, 4])
def test_stage_remat_is_bitwise_the_plain_pipeline(port, world):
    plain = next(i for i, (m, r) in enumerate(CASES[world])
                 if m == world and not r)
    remat = next(i for i, (m, r) in enumerate(CASES[world]) if r)
    for rank in port(world):
        a, b = rank["pipe"][plain], rank["pipe"][remat]
        np.testing.assert_array_equal(a["y"], b["y"])
        np.testing.assert_array_equal(a["grad"], b["grad"])


@pytest.mark.parametrize("world", [2, 4])
def test_rng_cells_match_the_sequential_oracle(port, world):
    for rank in port(world):
        plain, remat = rank["pipe"][-2:]
        np.testing.assert_array_equal(plain["y"], plain["oracle"])
        np.testing.assert_array_equal(remat["y"], plain["y"])
        np.testing.assert_array_equal(remat["grad"], plain["grad"])
        assert (plain["y"] == 0).any()   # the draws masked something


def test_dp_rows_each_run_their_pipeline(port):
    params, x = _params(2, 3), _x(4, 9)
    want = np.asarray(jpipe.sequential_reference(params, x, _j_stage))
    rows = x.shape[0] // 2
    for rank in port(4):
        d = rank["dp"]["row"]
        np.testing.assert_allclose(rank["dp"]["y"],
                                   want[d * rows:(d + 1) * rows], atol=1e-5)


def test_tp_pipeline_matches_jax_reference(port):
    params, x, target = _tpp_inputs()
    y0 = np.asarray(jtpp.tp_pipeline_reference(params, x))
    ranks = port(4)
    for r in ranks:
        np.testing.assert_allclose(r["tpp"]["y0"], y0,
                                   atol=1e-5 * np.abs(y0).max(), rtol=0)
    # the same SGD steps on the JAX reference, latents clamped
    mask = jtpp.latent_mask(params)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    losses = []
    for _ in range(TPP["steps"]):
        loss, g = jax.value_and_grad(lambda q: ((jtpp.tp_pipeline_reference(
            q, x) - target) ** 2).sum() / x.shape[0])(p)
        p = {k: p[k] - TPP["lr"] * g[k] for k in p}
        p = {k: jnp.clip(v, -1, 1) if mask[k] else v for k, v in p.items()}
        losses.append(float(loss))
    specs = {"w1": (None, "model"), "b1": ("model",), "w2": ("model", None),
             "b2": (None,)}
    for r in ranks:
        np.testing.assert_allclose(r["tpp"]["losses"], losses, rtol=1e-5)
        m, s = r["tpp"]["coords"]
        for k, spec in specs.items():
            got, want = r["tpp"]["params"][k][s], np.asarray(p[k])[s]
            for dim, name in enumerate(spec):
                if name:
                    n = want.shape[dim] // 2
                    got = np.take(got, range(m * n, (m + 1) * n), axis=dim)
                    want = np.take(want, range(m * n, (m + 1) * n), axis=dim)
            np.testing.assert_allclose(got, want, atol=1e-3, rtol=0,
                                       err_msg=k)


@pytest.mark.parametrize("s,m", [(2, 2), (4, 4), (4, 8), (8, 8), (2, 6)])
def test_bubble_fraction_matches_jax(s, m):
    assert pipeline_bubble_fraction(s, m) == jpipe.pipeline_bubble_fraction(
        s, m)


def test_meshes_lay_ranks_out_row_major_as_jax(port):
    """``make_mesh`` lays the world out as JAX reshapes ``jax.devices()``
    (row-major, the last axis fastest); each axis's group holds the ranks
    of its line; ``make_hybrid_mesh``'s leading axis is the node-major
    block. An indivisible model width raises JAX's message."""
    for rank, r in enumerate(port(4)):
        (s2, c2, l2), (s3, c3, l3), (sh, ch, lh) = r["mesh"]["meshes"]
        assert s2 == {"data": 2, "model": 2}
        assert c2 == {"data": rank // 2, "model": rank % 2}
        assert l2["model"] == ([rank // 2 * 2, rank // 2 * 2 + 1],
                               float(4 * (rank // 2) + 1))
        assert l2["data"][0] == [rank % 2, rank % 2 + 2]
        assert s3 == {"data": 1, "model": 2, "pipe": 2}
        assert c3 == {"data": 0, "model": rank // 2, "pipe": rank % 2}
        assert l3["pipe"][0] == [rank // 2 * 2, rank // 2 * 2 + 1]
        assert l3["data"] == ([rank], float(rank))
        assert sh == {"replica": 2, "model": 2}
        assert ch == {"replica": rank // 2, "model": rank % 2}
        assert lh["replica"][0] == [rank % 2, rank % 2 + 2]
        assert r["mesh"]["bad"] == "4 devices not divisible by model=3"


def test_meshes_need_a_process_group():
    with pytest.raises(ValueError):
        make_mesh(data=1, model=2)
