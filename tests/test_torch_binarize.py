"""binarize_ste / quantize of the PyTorch port against the JAX package:
forward values and straight-through gradients, bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu.ops.binarize import binarize_ste, quantize
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
