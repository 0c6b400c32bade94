"""Shared fixtures of the ViT and pipeline parity tests of the PyTorch
port: JAX transformer families built small, every parameter redrawn from
a numpy seed (latents in [-1, 1], LN scales around 1, non-zero biases:
no exact ties at a trivial init), carried into the port through
``interop.params_from_jax`` / ``lm_params_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np

from distributed_mnist_bnns_tpu.models import BinarizedTransformer as JViT
from distributed_mnist_bnns_tpu_torch.interop import params_from_jax

VIT = dict(embed_dim=32, depth=2, num_heads=2, patch_size=7)


def jax_vit(**kw):
    return JViT(**{**VIT, "backend": "xla", "attention": "xla", **kw})


def redraw(shapes, seed=0):
    """``shapes`` (a flax params tree) with every leaf redrawn from a
    numpy seed, as numpy arrays."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        names = [getattr(p, "key", str(p)) for p in path]
        shape = np.shape(x)
        if names[-1] == "scale":
            v = 1.0 + 0.2 * rng.randn(*shape)
        elif names[-1] == "bias":
            v = 0.2 * rng.randn(*shape)
        elif len(names) >= 2 and names[-2].startswith("Binarized"):
            v = rng.uniform(-1.0, 1.0, shape)
        elif names[-1] == "embedding":
            v = rng.randn(*shape)
        else:                      # pos_embed, head and fp32 kernels
            v = rng.randn(*shape) * 0.3
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def vit_params(model, seed=0):
    shapes = model.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((1, 28, 28, 1)), train=False)["params"]
    return redraw(shapes, seed)


def vit_pair(seed=0, **kw):
    """(JAX ViT, numpy params, port ViT in eval) on the same weights."""
    jm = jax_vit(**kw)
    params = vit_params(jm, seed)
    tm = params_from_jax({"params": params}, num_heads=jm.num_heads,
                         scale=jm.scale, backend="xla", attention="xla")
    return jm, params, tm


def images(seed, n):
    return np.random.RandomState(seed).rand(n, 28, 28, 1).astype(np.float32)


def np_tree(tree):
    if hasattr(tree, "items"):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def assert_trees_close(got, want, atol, rtol=0.0, skip=()):
    """Every leaf of ``want`` (nested dicts) within tolerance of
    ``got``'s; leaves whose path holds a name of ``skip`` are left out."""
    def walk(a, b, path):
        if isinstance(b, dict):
            assert set(a) == set(b), (path, sorted(a), sorted(b))
            for k in b:
                walk(a[k], b[k], path + (k,))
            return
        if any(s in path for s in skip):
            return
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                                   rtol=rtol, err_msg="/".join(path))

    walk(got, want, ())
