"""Shared fixtures of the LM parity tests of the PyTorch port: the tiny
BinarizedLM of ``tests/test_lm_serve.py`` (vocab 32, max_len 32, embed
32, depth 2, heads 2, backend "xla") with every parameter drawn from a
numpy seed, built in the JAX package and carried into the port."""

import jax
import jax.numpy as jnp
import numpy as np

from distributed_mnist_bnns_tpu.infer_transformer import _freeze_lm_tensors
from distributed_mnist_bnns_tpu.models.transformer import BinarizedLM as JLM
from distributed_mnist_bnns_tpu_torch.interop import (
    frozen_lm_from_jax,
    lm_params_from_jax,
)

TINY = dict(vocab=32, max_len=32, embed_dim=32, depth=2, num_heads=2)


def jax_lm(scale=False, binarized_attention=None, attention="xla",
           backend="xla", **kw):
    return JLM(**{**TINY, **kw}, attention=attention, backend=backend,
               scale=scale, binarized_attention=binarized_attention)


def numpy_params(model, seed=0):
    """``model``'s params with every leaf redrawn from a numpy seed:
    latents in [-1, 1], LN scales around 1, non-zero biases, so no
    parameter is at its trivial init."""
    shapes = model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4), jnp.int32)
    )["params"]
    rng = np.random.RandomState(seed)
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    leaves = {}
    for path, leaf in flat:
        names = [getattr(p, "key", str(p)) for p in path]
        shape = np.shape(leaf)
        if names[-1] == "scale":
            v = 1.0 + 0.2 * rng.randn(*shape)
        elif names[-1] == "bias":
            v = 0.2 * rng.randn(*shape)
        elif any(n.startswith("Binarized") for n in names):
            v = rng.uniform(-1.0, 1.0, shape)
        elif names[-1] == "embedding":
            v = rng.randn(*shape)
        else:                      # pos_embed, head and fp32 kernels
            v = rng.randn(*shape) * 0.3
        leaves[tuple(names)] = v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(
        lambda p, _: leaves[tuple(getattr(k, "key", str(k)) for k in p)],
        shapes,
    )


def lm_pair(seed=0, scale=False, binarized_attention=None, attention="xla",
            **kw):
    """(jax model, numpy params, port model in eval) on the same weights.
    ``attention="flash"`` is the JAX model's ``"flash_interpret"``."""
    jm = jax_lm(scale=scale, binarized_attention=binarized_attention,
                attention="flash_interpret" if attention == "flash"
                else attention, **kw)
    params = numpy_params(jm, seed)
    tm = lm_params_from_jax(params, num_heads=TINY["num_heads"], scale=scale,
                            backend="xla", attention=attention)
    return jm, params, tm


def frozen_pair(seed=0, scale=False, binarized_attention=None):
    """(JAX frozen dict with numpy leaves, the port's frozen dict)."""
    jm, params, _ = lm_pair(seed, scale, binarized_attention)
    jfrozen = jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x,
        _freeze_lm_tensors(jm, {"params": params}),
    )
    return jfrozen, frozen_lm_from_jax(jfrozen)


def tokens(seed, n, vocab=TINY["vocab"]):
    return np.random.RandomState(seed).randint(0, vocab, size=n).astype(
        np.int32
    )
