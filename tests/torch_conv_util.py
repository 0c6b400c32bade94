"""Shared fixtures of the conv families' parity tests: JAX models and
variables made from numpy seeds, carried into the port with
``interop.params_from_jax``.

Variables draw non-zero biases, BatchNorm scales of both signs (and some
zero) and BatchNorm statistics of the pre-activations' scale, so that no
binarized layer sits on an exact tie (ROADMAP queue 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from distributed_mnist_bnns_tpu.models import get_model as jget_model
from distributed_mnist_bnns_tpu_torch.interop import (
    params_from_jax,
    to_flax_layout,
)
from distributed_mnist_bnns_tpu_torch.models import get_model

#: the four families at the widths of the tests: bnn-cnn as the JAX
#: package's own test_infer_conv.py cuts it, the rest at full width
FAMILIES = {
    "convnet": {},
    "deep-cnn": {"dropout_rate": 0.0},
    "bnn-cnn": {"widths": (16, 32), "hidden": 128},
    "fp32-mlp-large": {"infl_ratio": 1, "dropout_rate": 0.0},
}


def np_tree(t):
    if hasattr(t, "items"):
        return {k: np_tree(v) for k, v in t.items()}
    return np.array(t)


def pixels(n=8, seed=0):
    """MNIST-normalised pixels, multiples of 1/256 before normalising."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (n, 28, 28, 1)) / 256.0 - 0.1307
    return (x / 0.3081).astype(np.float32)


def labels(n=8, seed=0):
    return np.random.RandomState(seed + 100).randint(0, 10, n).astype(
        np.int32)


def jax_model(name, **kw):
    return jget_model(name, **{**FAMILIES[name], **kw})


def jax_variables(name, seed=0, **kw):
    """A flax init of ``name`` with drawn biases and BatchNorm state."""
    model = jax_model(name, **kw)
    v = np_tree(model.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, 28, 28, 1)), train=False))
    rng = np.random.RandomState(seed + 11)
    for mod, leaves in v["params"].items():
        if "bias" in leaves:
            b = leaves["bias"]
            leaves["bias"] = (rng.randn(*b.shape) * 0.3).astype(np.float32)
        if mod.startswith("BatchNorm"):
            c = leaves["scale"].shape[0]
            scale = (rng.rand(c) + 0.5).astype(np.float32)
            scale[1::7] = -scale[1::7]
            scale[::11] = 0.0
            leaves["scale"] = scale
            v["batch_stats"][mod]["mean"] = (rng.randn(c) * 2).astype(
                np.float32)
            v["batch_stats"][mod]["var"] = (rng.rand(c) * 4 + 0.5).astype(
                np.float32)
    return model, v


def port_model(name, variables, **kw):
    """The port's ``name`` holding the JAX ``variables`` (eval mode)."""
    return params_from_jax(variables, model=get_model(
        name, **{**FAMILIES[name], **kw}))


def flax_grads(model):
    """{flax module: {leaf: array}} of the port model's ``.grad``s, in
    flax's names and layouts."""
    out = {}
    for sub, flax_name, kind in model.flax_names():
        mod = model.get_submodule(sub)
        out[flax_name] = {
            "scale" if kind == "bn" else "kernel":
                to_flax_layout(mod.weight.grad, kind).numpy(),
            "bias": mod.bias.grad.numpy()}
    return out
