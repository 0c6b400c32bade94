"""The port's losses (``ops/losses.py``) against the JAX package's: value
and gradient against ``jax.value_and_grad`` on the same numpy inputs,
at rtol 1e-6 (float32 sums in two frameworks' orders), and the
per-example form the eval step sums against the JAX eval's vmap of the
batch loss over single rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu.ops import losses as jl
from distributed_mnist_bnns_tpu_torch.ops import losses as tl

RTOL = 1e-6
B, C = 16, 10


def _inputs(seed=0, log_probs=False):
    rng = np.random.RandomState(seed)
    out = (rng.randn(B, C) * 2.0).astype(np.float32)
    if log_probs:
        out = np.asarray(jax.nn.log_softmax(out), np.float32)
    labels = rng.randint(0, C, size=B).astype(np.int32)
    return out, labels


def _port_value_and_grad(fn, out, labels):
    o = torch.from_numpy(out.copy()).requires_grad_(True)
    loss = fn(o, torch.from_numpy(labels).long())
    loss.backward()
    return loss.item(), o.grad.numpy()


def _check(jax_fn, port_fn, out, labels):
    want, gwant = jax.value_and_grad(jax_fn)(jnp.asarray(out),
                                             jnp.asarray(labels))
    got, ggot = _port_value_and_grad(port_fn, out, labels)
    np.testing.assert_allclose(got, float(want), rtol=RTOL)
    np.testing.assert_allclose(ggot, np.asarray(gwant), rtol=RTOL,
                               atol=1e-9)


@pytest.mark.parametrize("log_probs", [False, True])
def test_cross_entropy_matches_optax(log_probs):
    """Logits or log-probs alike (the reference's double log-softmax)."""
    out, labels = _inputs(1, log_probs)
    _check(jl.cross_entropy_loss, tl.cross_entropy_loss, out, labels)


@pytest.mark.parametrize("name,smoothing", [
    ("ce", 0.0), ("ce", 0.1), ("hinge", 0.0), ("sqrt_hinge", 0.0)])
def test_make_loss_matches_jax(name, smoothing):
    out, labels = _inputs(2)
    _check(jl.make_loss(name, C, smoothing),
           tl.make_loss(name, C, smoothing), out, labels)


def test_hinge_loss_on_pm1_targets_and_its_tie_gradient():
    """``hinge_loss`` on ±1 targets; where 1 - y t is exactly 0 both
    frameworks pass half the gradient (jnp.maximum's tie rule)."""
    out, labels = _inputs(3)
    t = (2.0 * np.eye(C, dtype=np.float32)[labels] - 1.0)
    out[0, :3] = t[0, :3]            # 1 - y t == 0 exactly
    _check(jl.hinge_loss, tl.hinge_loss, out, t)


def test_sqrt_hinge_custom_backward_is_the_reference_formula():
    """The handwritten backward ``-2 t err / B g``, against the JAX
    custom_vjp and against the formula itself, with the output's
    gradient only (the target gets none)."""
    out, labels = _inputs(4)
    t = (2.0 * np.eye(C, dtype=np.float32)[labels] - 1.0)
    _check(jl.sqrt_hinge_loss, tl.sqrt_hinge_loss, out, t)
    o = torch.from_numpy(out.copy()).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    (tl.sqrt_hinge_loss(o, tt) * 3.0).backward()
    err = np.maximum(0.0, 1.0 - out * t)
    np.testing.assert_allclose(o.grad.numpy(), -2.0 * t * err / B * 3.0,
                               rtol=RTOL)
    assert tt.grad is None


@pytest.mark.parametrize("name,smoothing", [
    ("ce", 0.0), ("ce", 0.1), ("hinge", 0.0), ("sqrt_hinge", 0.0)])
def test_per_example_is_the_batch_loss_of_each_row(name, smoothing):
    """The eval sums: JAX vmaps the batch loss over single rows."""
    out, labels = _inputs(5)
    jfn = jl.make_loss(name, C, smoothing)
    want = jax.vmap(lambda o, y: jfn(o[None], y[None]))(
        jnp.asarray(out), jnp.asarray(labels))
    got = tl.make_loss(name, C, smoothing).per_example(
        torch.from_numpy(out), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-7)


def test_make_loss_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="only applies"):
        tl.make_loss("hinge", label_smoothing=0.1)
    with pytest.raises(ValueError, match="must be in"):
        tl.make_loss("ce", label_smoothing=1.5)
    with pytest.raises(ValueError, match="unknown loss"):
        tl.make_loss("mse")
