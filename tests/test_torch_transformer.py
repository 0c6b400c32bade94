"""The PyTorch port's BinarizedLM against the JAX package's.

The tiny LM of ``tests/test_lm_serve.py`` with every parameter drawn from
a numpy seed (``tests/torch_lm_util.py``), carried across with
``interop.lm_params_from_jax``. Log-probs agree to atol 1e-4 and the
argmax everywhere: LayerNorm and attention round in other orders, so not
bitwise, and a last-ulp difference just before a binarized projection
could flip a sign.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from distributed_mnist_bnns_tpu_torch.models import BinarizedLM
from distributed_mnist_bnns_tpu_torch.models.layers import BinarizedDense
from distributed_mnist_bnns_tpu_torch.models.transformer import (
    BinarizedSelfAttention,
    layer_norm,
)
from tests.torch_lm_util import TINY, lm_pair, tokens


@pytest.mark.parametrize("kw", [
    {}, {"scale": True}, {"binarized_attention": False},
], ids=["binarized", "scale", "fp32-attention"])
def test_live_model_matches_jax(kw):
    jm, params, tm = lm_pair(seed=0, **kw)
    toks = np.stack([tokens(1, 20), tokens(2, 20)])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(toks),
                               train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks).long()).numpy()
    assert got.shape == (2, 20, TINY["vocab"])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_layer_norm_is_flax_layer_norm():
    rng = np.random.RandomState(3)
    x = (rng.randn(5, 7, 32) * 3 + 1).astype(np.float32)
    scale = (1 + 0.2 * rng.randn(32)).astype(np.float32)
    bias = (0.2 * rng.randn(32)).astype(np.float32)
    want = np.asarray(fnn.LayerNorm().apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
        jnp.asarray(x),
    ))
    got = layer_norm(*map(torch.from_numpy, (x, scale, bias))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    # epsilon 1e-6, not PyTorch's 1e-5: a constant row normalizes to ~0
    # either way, but the scale of a near-constant row shows it
    flat = np.full((1, 32), 2.0, np.float32)
    flat[0, 0] += 1e-3
    want = np.asarray(fnn.LayerNorm(use_bias=False, use_scale=False).apply(
        {}, jnp.asarray(flat)))
    got = layer_norm(torch.from_numpy(flat), torch.ones(32),
                     torch.zeros(32)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_state_dict_names_follow_the_flax_tree():
    _, _, tm = lm_pair(seed=1, binarized_attention=False)
    names = set(tm.state_dict())
    assert {"tok_embed.weight", "pos_embed", "ln_head.weight", "head.bias",
            "blocks.1.attn.out.weight", "blocks.0.mlp2.bias",
            "blocks.0.ln_mlp.weight"} <= names
    assert isinstance(tm.blocks[0].attn.q, torch.nn.Linear)
    assert isinstance(tm.blocks[0].mlp1, BinarizedDense)


def test_scale_is_the_mean_absolute_latent():
    gen = torch.Generator().manual_seed(0)
    layer = BinarizedDense(8, 4, scale=True, backend="xla", generator=gen)
    plain = BinarizedDense(8, 4, backend="xla")
    plain.load_state_dict(layer.state_dict())
    with torch.no_grad():
        layer.bias.normal_(generator=gen)
        plain.bias.copy_(layer.bias)
        x = torch.randn(3, 8, generator=gen)
        alpha = layer.weight.abs().mean(dim=1)
        torch.testing.assert_close(
            layer(x), (plain(x) - plain.bias) * alpha + layer.bias,
            rtol=0, atol=0,
        )


def test_flash_attention_raises_naming_the_kernel():
    with pytest.raises(NotImplementedError, match="K4"):
        BinarizedLM(**TINY, attention="flash")
    with pytest.raises(NotImplementedError, match="K4"):
        BinarizedSelfAttention(32, 2, attention="flash")
    with pytest.raises(ValueError, match="unknown attention"):
        BinarizedLM(**TINY, attention="ring")


def test_dropout_is_inactive_in_eval_and_live_in_train():
    gen = torch.Generator().manual_seed(0)
    a = BinarizedLM(**TINY, dropout=0.5, generator=gen)
    b = BinarizedLM(**TINY, dropout=0.0)
    b.load_state_dict(a.state_dict())
    toks = torch.from_numpy(tokens(4, 12)[None]).long()
    a.eval(), b.eval()
    with torch.no_grad():
        torch.testing.assert_close(a(toks), b(toks), rtol=0, atol=0)
        a.train()
        torch.manual_seed(0)
        assert not torch.equal(a(toks), b(toks))


def test_too_long_a_sequence_raises():
    lm = BinarizedLM(**TINY)
    with pytest.raises(ValueError, match="max_len"):
        lm(torch.zeros((1, TINY["max_len"] + 1), dtype=torch.long))
