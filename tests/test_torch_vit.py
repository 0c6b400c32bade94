"""The port's binarized vision transformer (``models.transformer.
BinarizedTransformer``, ``bnn-vit-tiny``/``-small``, the fp32 twins)
against the JAX package's.

A small ViT (embed 32, depth 2, 2 heads, 7x7 patches of 28x28 images,
backend xla) with every parameter redrawn from a numpy seed
(``tests/torch_vit_util.py``) is carried into the port with
``interop.params_from_jax``. Held to JAX:
  * the registry entries' parameter trees (every flax path and shape);
  * the eval forward (log-probs) to atol 1e-5, binarized, fp32 twin,
    partial binarization and XNOR-Net scale;
  * the gradients of the mean cross entropy, each leaf in flax's layout,
    to 3e-5 of the largest (measured 1.3e-5 of it: fp32 sums through
    two blocks' attention backward taken in other orders);
  * ``JaxFlatOrder`` bitwise ``ravel_pytree``'s vector, the clamp mask
    the JAX ``latent_clamp_mask``'s leaves;
  * three SGD steps of the port's ``Trainer`` against the JAX Trainer's
    from the same state (losses rtol 1e-5, parameters atol 1e-5), and the
    port's checkpoint restored by the JAX ``load_checkpoint``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from jax.flatten_util import ravel_pytree

from distributed_mnist_bnns_tpu.models import get_model as j_get_model
from distributed_mnist_bnns_tpu.models import latent_clamp_mask as j_mask
from distributed_mnist_bnns_tpu.train import trainer as jtrainer
from distributed_mnist_bnns_tpu.utils import checkpoint as jckpt
from distributed_mnist_bnns_tpu_torch.interop import (
    JaxFlatOrder,
    flax_params,
    train_state_from_jax,
    train_state_to_jax,
)
from distributed_mnist_bnns_tpu_torch.models import (
    get_model,
    latent_clamp_mask,
)
from distributed_mnist_bnns_tpu_torch.ops.losses import cross_entropy_loss
from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer
from tests.torch_vit_util import (
    VIT,
    assert_trees_close,
    images,
    np_tree,
    redraw,
    vit_pair,
)

VARIANTS = {
    "binarized": {},
    "fp32": {"binarized": False},
    "partial": {"binarized_attention": False},
    "scale": {"scale": True},
}


@pytest.mark.parametrize("name", ["bnn-vit-tiny", "bnn-vit-small",
                                  "fp32-vit-tiny", "fp32-vit-small"])
def test_registry_widths_match_jax(name):
    jm = j_get_model(name)
    want = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 28, 28, 1)),
        train=False))["params"]
    got = flax_params(get_model(name))
    assert got == jax.tree_util.tree_map(lambda s: tuple(s.shape), want)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax(variant):
    jm, params, tm = vit_pair(seed=1, **VARIANTS[variant])
    x = images(2, 6)
    want = np.asarray(jm.apply({"params": params}, x, train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # flat (B, 784) images are the MLP's layout: the same forward
    with torch.no_grad():
        flat = tm(torch.from_numpy(x.reshape(6, -1))).numpy()
    np.testing.assert_array_equal(flat, got)


@pytest.mark.parametrize("variant", ["binarized", "fp32"])
def test_gradients_match_jax(variant):
    jm, params, tm = vit_pair(seed=3, **VARIANTS[variant])
    x = images(4, 8)
    y = np.random.RandomState(5).randint(0, 10, 8)

    def loss_fn(p):
        lp = jm.apply({"params": p}, x, train=False)
        return -jnp.take_along_axis(lp, y[:, None], axis=-1).mean()

    want_loss, want = jax.value_and_grad(loss_fn)(params)
    tm.zero_grad()
    loss = cross_entropy_loss(tm(torch.from_numpy(x)),
                              torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    order = JaxFlatOrder(tm)
    got = order.flatten({p: p.grad for _, p, _ in order.entries})
    want = np.asarray(ravel_pytree(want)[0])
    np.testing.assert_allclose(got.numpy(), want,
                               atol=3e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_flat_order_and_clamp_mask_match_jax(variant):
    jm, params, tm = vit_pair(seed=6, **VARIANTS[variant])
    np.testing.assert_array_equal(JaxFlatOrder(tm).flatten().numpy(),
                                  np.asarray(ravel_pytree(params)[0]))
    mask = jax.tree_util.tree_flatten_with_path(j_mask(params))[0]
    want = {"/".join(p.key for p in path[:-1]) for path, m in mask if m}
    flax_of = {sub: fl for sub, fl, _ in tm.flax_names()}
    got = {flax_of[name.rsplit(".", 1)[0]]
           for name in latent_clamp_mask(tm)}
    assert got == want


def _cfg(**kw):
    return dict(model="bnn-vit-tiny", model_kwargs=dict(VIT), backend="xla",
                optimizer="sgd", learning_rate=0.05, batch_size=8, seed=0,
                **kw)


@pytest.fixture(scope="module")
def trained_pair():
    """The JAX Trainer's state with redrawn params, three SGD steps on it
    and on the port's Trainer loaded from it."""
    jt = jtrainer.Trainer(jtrainer.TrainConfig(**_cfg()))
    state = jt.state.replace(params=redraw(jt.state.params, seed=8))
    pt = Trainer(TrainConfig(device="cpu", log_interval=1, **_cfg()))
    train_state_from_jax(np_tree(serialization.to_state_dict(state)), pt)
    rng = np.random.RandomState(9)
    xs = rng.rand(3, 8, 28, 28, 1).astype(np.float32)
    ys = rng.randint(0, 10, (3, 8)).astype(np.int32)
    key = jax.random.PRNGKey(0)
    jl, pl = [], []
    for x, y in zip(xs, ys):
        state, m = jt.train_step(state, x, y, key)
        jl.append(float(m["loss"]))
        loss, _ = pt.train_step(pt.model, pt.optimizer, torch.from_numpy(x),
                                torch.from_numpy(y.astype(np.int64)))
        pl.append(float(loss))
    pt.step = 3
    return jt, state, pt, jl, pl


def test_trainer_steps_match_jax(trained_pair):
    _, state, pt, jl, pl = trained_pair
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert_trees_close(train_state_to_jax(pt)["params"],
                       np_tree(state.params), atol=1e-5)


def test_checkpoint_restores_in_jax(trained_pair, tmp_path):
    _, _, pt, _, _ = trained_pair
    path = pt.save_checkpoint(str(tmp_path))
    template = jtrainer.Trainer(jtrainer.TrainConfig(**_cfg())).state
    restored = jckpt.load_checkpoint(template, str(tmp_path))
    assert_trees_close(np_tree(serialization.to_state_dict(restored)),
                       np_tree(train_state_to_jax(pt)), atol=0)
    fresh = Trainer(TrainConfig(device="cpu", **_cfg()))
    fresh.restore(str(tmp_path))
    for a, b in zip(fresh.model.state_dict().values(),
                    pt.model.state_dict().values()):
        assert torch.equal(a, b)
    assert path.endswith("checkpoint.msgpack")


def test_cli_train_vit_on_the_cpu(tmp_path, capsys):
    from distributed_mnist_bnns_tpu_torch.cli import main

    rc = main(["train", "--model", "bnn-vit-tiny", "--epochs", "1",
               "--batch-size", "32", "--backend", "xla", "--device", "cpu",
               "--data-dir", str(tmp_path / "none"),
               "--synthetic-sizes", "256", "64", "--lr", "0.003"])
    assert rc == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["model"] == "bnn-vit-tiny" and np.isfinite(row["train_loss"])
