"""binarize_ste / quantize of the PyTorch port against the JAX package:
forward values and straight-through gradients, bitwise. The stochastic
paths are fed the JAX package's own noise (the same key's uniform draw)
and compared bitwise; the port's own draws are checked for their mean
and for reproducibility from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu.ops.binarize import (
    binarize,
    binarize_ste,
    quantize,
)
from distributed_mnist_bnns_tpu_torch.ops import binarize as tb


def _inputs():
    x = (np.random.RandomState(0).randn(6, 50) * 1.5).astype(np.float32)
    x[0, :5] = [0.0, -0.0, 1.0, -1.0, 1.0000001]
    return x


def test_forward_maps_zero_to_plus_one():
    x = _inputs()
    got = tb.binarize_ste(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(binarize_ste(x)))
    assert got[0, 0] == 1.0 and got[0, 1] == 1.0
    assert set(np.unique(got)) == {-1.0, 1.0}


@pytest.mark.parametrize("ste", ["identity", "hardtanh"])
def test_ste_gradient_matches_jax_grad(ste):
    x = _inputs()
    g = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    want = jax.grad(
        lambda v: jnp.sum(binarize_ste(v, ste) * g)
    )(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tb.binarize_ste(xt, ste) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    if ste == "hardtanh":
        assert (xt.grad.numpy()[np.abs(x) > 1.0] == 0.0).all()


def test_unknown_ste_mode_raises():
    with pytest.raises(ValueError, match="STE"):
        tb.binarize_ste(torch.zeros(3), "clip")


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_matches_jax_forward_and_gradient(bits):
    x = np.random.RandomState(bits).uniform(-1.2, 1.2, (8, 40))
    x = x.astype(np.float32)
    x[0, :3] = [0.5 / 2 ** (bits - 1), 1.5 / 2 ** (bits - 1), 1.0]  # ties
    np.testing.assert_array_equal(
        tb.quantize(torch.from_numpy(x), bits).numpy(),
        np.asarray(quantize(jnp.asarray(x), "det", bits)),
    )
    xt = torch.from_numpy(x).requires_grad_(True)
    tb.quantize(xt, bits).sum().backward()
    want = jax.grad(lambda v: jnp.sum(quantize(v, "det", bits)))(x)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


def _jax_noise(key, shape):
    """The noise JAX's stochastic paths draw from ``key``."""
    return np.array(jax.random.uniform(key, shape, jnp.float32, -0.5, 0.5))


def _stoch_inputs():
    x = np.random.RandomState(3).uniform(-1.5, 1.5, (8, 64)).astype(
        np.float32)
    x[0, :6] = [0.0, -0.0, 1.0, -1.0, 0.5, -0.5]
    return x


@pytest.mark.parametrize("ste", ["identity", "hardtanh"])
def test_stochastic_binarize_matches_jax_on_its_noise(ste):
    x = _stoch_inputs()
    key = jax.random.PRNGKey(7)
    noise = _jax_noise(key, x.shape)
    want = binarize(jnp.asarray(x), "stoch", ste=ste, key=key)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tb.binarize_stoch(xt, torch.from_numpy(noise), ste)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert set(np.unique(got.detach().numpy())) == {-1.0, 1.0}
    g = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    gwant = jax.grad(lambda v: jnp.sum(
        binarize(v, "stoch", ste=ste, key=key) * g))(jnp.asarray(x))
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gwant))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_stochastic_quantize_matches_jax_on_its_noise(bits):
    x = _stoch_inputs()
    key = jax.random.PRNGKey(bits)
    noise = _jax_noise(key, x.shape)
    want = quantize(jnp.asarray(x), "stoch", bits, key=key)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tb.quantize_stoch(xt, torch.from_numpy(noise), bits)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.sum().backward()
    gwant = jax.grad(lambda v: jnp.sum(
        quantize(v, "stoch", bits, key=key)))(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gwant))


def test_stochastic_binarize_draws_have_mean_x():
    """E[stoch(x)] = x on [-1, 1]: P(+1) = (1 + x) / 2. Each mean of
    10^5 draws lies within 3 standard deviations, sqrt(1 - x^2 / n)."""
    n = 100_000
    xs = torch.tensor([-0.95, -0.6, -0.2, 0.0, 0.3, 0.75])
    x = xs[:, None].expand(-1, n).contiguous()
    gen = torch.Generator().manual_seed(11)
    out = tb.binarize(x, "stoch", generator=gen)
    assert set(out.unique().tolist()) == {-1.0, 1.0}
    mean = out.double().mean(dim=1)
    sigma = torch.sqrt((1 - xs.double() ** 2) / n)
    assert torch.all((mean - xs.double()).abs() <= 3 * sigma), (mean, xs)


def test_stochastic_draws_follow_the_generator_seed():
    x = torch.from_numpy(_stoch_inputs())

    def draw(seed, fn):
        return fn(x, torch.Generator().manual_seed(seed))

    for fn in (lambda v, g: tb.binarize(v, "stoch", generator=g),
               lambda v, g: tb.quantize(v, 4, quant_mode="stoch",
                                        generator=g)):
        assert torch.equal(draw(5, fn), draw(5, fn))
        assert not torch.equal(draw(5, fn), draw(6, fn))
    with pytest.raises(ValueError, match="generator"):
        tb.binarize(x, "stoch")
    with pytest.raises(ValueError, match="quant_mode"):
        tb.binarize(x, "noisy")
