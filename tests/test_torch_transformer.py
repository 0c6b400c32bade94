"""The PyTorch port's BinarizedLM against the JAX package's.

The tiny LM of ``tests/test_lm_serve.py`` with every parameter drawn from
a numpy seed (``tests/torch_lm_util.py``), carried across with
``interop.lm_params_from_jax``. Log-probs agree to atol 1e-4 and the
argmax everywhere: LayerNorm and attention round in other orders, so not
bitwise, and a last-ulp difference just before a binarized projection
could flip a sign.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from distributed_mnist_bnns_tpu_torch.models import BinarizedLM
from distributed_mnist_bnns_tpu_torch.models.layers import BinarizedDense
from distributed_mnist_bnns_tpu_torch.models.transformer import (
    BinarizedSelfAttention,
    TransformerBlock,
    hard_tanh,
    layer_norm,
)
from tests.torch_lm_util import TINY, lm_pair, tokens


@pytest.mark.parametrize("kw", [
    {}, {"scale": True}, {"binarized_attention": False},
    {"attention": "flash"},
], ids=["binarized", "scale", "fp32-attention", "flash"])
def test_live_model_matches_jax(kw):
    """``attention="flash"``: the port's flash plain versions against the
    JAX model's ``"flash_interpret"`` (the Pallas kernels interpreted)."""
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
    """``"flash"`` builds and runs the flash kernels' entry: a CPU tensor
    takes the plain versions, any other non-CUDA device raises (no
    silent fallback); an unknown attention raises at construction."""
    attn = BinarizedSelfAttention(32, 2, attention="flash", causal=True)
    assert BinarizedLM(**TINY, attention="flash").blocks[0].attn.attention \
        == "flash"
    x = torch.randn(2, 5, 32, generator=torch.Generator().manual_seed(0))
    assert attn(x).shape == (2, 5, 32)
    with pytest.raises(ValueError, match="no flash attention for device meta"):
        attn.to("meta")(x.to("meta"))
    with pytest.raises(ValueError, match="unknown attention"):
        BinarizedLM(**TINY, attention="ring")
    with pytest.raises(ValueError, match="unknown attention"):
        BinarizedSelfAttention(32, 2, attention="flash_interpret")


def test_mlp_activation_passes_the_gradient_at_plus_minus_one():
    """flax's nn.hard_tanh has gradient 1 at exactly ±1 (F.hardtanh has
    0 there); the block's activation follows flax."""
    pts = np.array([-1.5, -1.0, -0.25, 0.0, 0.5, 1.0, 2.0, 1.0], np.float32)
    want = np.asarray(jax.grad(lambda v: fnn.hard_tanh(v).sum())(
        jnp.asarray(pts)))
    np.testing.assert_array_equal(want, [0, 1, 1, 1, 1, 1, 0, 1])
    y = torch.from_numpy(pts.reshape(1, 1, 8)).requires_grad_()
    hard_tanh(y).sum().backward()
    np.testing.assert_array_equal(y.grad.numpy().ravel(), want)

    class Fixed(torch.nn.Module):
        def forward(self, _):
            return y

    # Inside the block: mlp1's output y feeds mlp2, whose ±1 weights
    # (latents all +1) send a gradient of 4 (its outputs) to each input.
    y.grad = None
    block = TransformerBlock(4, 1, mlp_ratio=2, backend="xla")
    block.mlp1 = Fixed()
    with torch.no_grad():
        block.mlp2.weight.fill_(1.0)
    block(torch.zeros(1, 1, 4)).sum().backward()
    np.testing.assert_array_equal(y.grad.numpy().ravel(), 4.0 * want)


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


def test_embed_matches_the_lookup_and_its_gradient():
    """``embed`` is ``nn.functional.embedding`` forward; its one-hot
    weight gradient sums each row's cotangents as the lookup's backward
    does (bitwise on integer cotangents, where no order can round), and
    tokens that never occur get a zero row."""
    from distributed_mnist_bnns_tpu_torch.models.transformer import embed

    rng = np.random.RandomState(4)
    tokens = torch.from_numpy(rng.randint(0, 12, (3, 40)))
    w = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    g = torch.from_numpy(rng.randint(-4, 5, (3, 40, 8)).astype(np.float32))
    wa, wb = w.clone().requires_grad_(), w.clone().requires_grad_()
    ya, yb = embed(tokens, wa), torch.nn.functional.embedding(tokens, wb)
    assert torch.equal(ya, yb)
    (ya * g).sum().backward()
    (yb * g).sum().backward()
    assert torch.equal(wa.grad, wb.grad)
    assert not wa.grad[12:].any()
    gr = torch.from_numpy(rng.randn(3, 40, 8).astype(np.float32))
    wa.grad = wb.grad = None
    (embed(tokens, wa) * gr).sum().backward()
    (torch.nn.functional.embedding(tokens, wb) * gr).sum().backward()
    torch.testing.assert_close(wa.grad, wb.grad, rtol=1e-6, atol=1e-6)
