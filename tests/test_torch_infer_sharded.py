"""The port's sharded frozen predictor (``infer.make_sharded_predictor``)
on 2 gloo ranks on the CPU (one spawn for every family), against the
single-process frozen predictor and the JAX ``make_sharded_predictor``
over 2 forced CPU devices (Pallas kernels in interpret mode), on the
same JAX-trained artifacts (``interop.frozen_from_jax``). The rank side
is ``tests/torch_moe_util.py``.

Each rank predicts its rows and the outputs are gathered in rank order,
so the MLP, the ViT and the QNN equal the single-process forward; the
MoE routes each shard alone (capacity from the shard's rows), as JAX
documents and tests, so it equals the per-shard forwards concatenated
and not the global batch's routing. Tolerances are JAX's tests': 1e-5
(the ViT 1e-4); the port's own sharded and single forwards run the same
code on the same rows and are compared bitwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from distributed_mnist_bnns_tpu.infer import _freeze_any as jfreeze
from distributed_mnist_bnns_tpu.infer import (
    make_sharded_predictor as jsharded,
)
from distributed_mnist_bnns_tpu.ops.losses import cross_entropy_loss
from distributed_mnist_bnns_tpu_torch.infer import _build_any
from distributed_mnist_bnns_tpu_torch.interop import frozen_from_jax
from distributed_mnist_bnns_tpu_torch.parallel import spawn
from tests import torch_moe_util as util
from tests.infer_train_util import trained_variables

WORLD = 2
FAMILIES = ("mlp", "vit", "moe", "qnn")
TOL = {"mlp": 1e-5, "vit": 1e-4, "moe": 1e-4, "qnn": 1e-5}


def _np_tree(t):
    return jax.tree.map(
        lambda a: np.array(a) if hasattr(a, "shape") else a, t)


def _train(model, n, **kw):
    x = jax.random.normal(jax.random.PRNGKey(3), (n, 28, 28, 1))
    labels = jax.random.randint(jax.random.PRNGKey(4), (n,), 0, 10)
    variables = trained_variables(
        model, x, lambda out: cross_entropy_loss(out, labels), **kw)
    return _np_tree(jfreeze(model, variables)), np.array(x)


@functools.lru_cache(maxsize=None)
def _case(family):
    """(JAX frozen dict as numpy, images) of each family, trained three
    steps as JAX's own test trains them."""
    if family == "mlp":
        from distributed_mnist_bnns_tpu.models.mlp import bnn_mlp_small

        return _train(bnn_mlp_small(backend="xla"), 32)
    if family == "vit":
        from distributed_mnist_bnns_tpu.models.transformer import (
            bnn_vit_tiny,
        )

        model = bnn_vit_tiny(attention="xla", backend="xla")
        x = jax.random.normal(jax.random.PRNGKey(3), (16, 28, 28, 1))
        labels = jax.random.randint(jax.random.PRNGKey(4), (16,), 0, 10)
        variables = trained_variables(
            model, x,
            lambda out: -jnp.take_along_axis(
                out, labels[:, None], axis=-1).mean(),
            init_rngs={"params": jax.random.PRNGKey(0)})
        return _np_tree(jfreeze(model, variables)), np.array(x)
    if family == "moe":
        from distributed_mnist_bnns_tpu.models.moe import BnnMoEMLP

        return _train(BnnMoEMLP(hidden=64, num_experts=4,
                                expert_features=64, backend="xla"), 32)
    from distributed_mnist_bnns_tpu.models.mlp import QnnMLP

    return _train(QnnMLP(hidden=(96, 64, 48)), 16)


@pytest.fixture(scope="module")
def ranks():
    return spawn(util.sharded_run, WORLD, backend="gloo", device="cpu",
                 args=([_case(f) for f in FAMILIES],), timeout_s=300.0)


def _single(family, x):
    fn = _build_any(frozen_from_jax(_case(family)[0]), torch.device("cpu"))
    return fn(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_equals_single_and_jax(family, ranks):
    frozen, x = _case(family)
    got = [r[FAMILIES.index(family)] for r in ranks]
    out = got[0]["out"]
    assert out.shape == (len(x), 10)
    np.testing.assert_array_equal(out, got[1]["out"])   # every rank
    if family == "moe":
        per = len(x) // WORLD
        want = np.concatenate([_single(family, x[i * per:(i + 1) * per])
                               for i in range(WORLD)])
    else:
        want = _single(family, x)
    np.testing.assert_array_equal(out, want)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    jout = np.asarray(jsharded(frozen, mesh, interpret=True)(
        jnp.asarray(x)))
    np.testing.assert_allclose(out, jout, atol=TOL[family],
                               rtol=TOL[family])


def test_sharded_moe_is_not_the_global_routing(ranks):
    """The MoE's per-shard answer differs from routing the whole batch on
    one process (capacity from 16 rows, not 32)."""
    frozen, x = _case("moe")
    out = ranks[0][FAMILIES.index("moe")]["out"]
    assert not np.array_equal(out, _single("moe", x))


@pytest.mark.parametrize("family", FAMILIES)
def test_indivisible_batch_raises(family, ranks):
    assert all(r[FAMILIES.index(family)]["raises_on_indivisible"]
               for r in ranks)
